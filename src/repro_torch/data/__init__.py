"""Synthetic data: the M2Bench-style multi-model scenario."""
