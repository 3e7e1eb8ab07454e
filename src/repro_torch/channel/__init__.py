"""Connectivity processes (the paper's i.i.d. channel)."""
