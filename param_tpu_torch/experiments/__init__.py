"""Experiments of the port: :mod:`.coalesce`, the coalesced-fetch experiment
on the card (K9, K10), and :mod:`.flash_host`, the host's cost of an eager
K6 / K7 call beside the card's time for it."""
