"""Operators of the port: embedding bag, sparse row update, MLP."""
