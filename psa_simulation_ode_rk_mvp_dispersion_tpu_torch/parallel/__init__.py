"""Batched sweeps."""
