"""Experiment configurations (the paper's own setup)."""
