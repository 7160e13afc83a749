"""Operators of the port: embedding bag, sparse row update, MLP, matmuls,
attention, ring attention, ring collectives."""
