"""Experiments of the port: :mod:`.coalesce`, the coalesced-fetch experiment
on the card (K9, K10)."""
