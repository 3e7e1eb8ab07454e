"""Datasets, partitions and per-client batch streams (numpy copies of
``repro.data``: the same seed gives the same data and batches)."""
