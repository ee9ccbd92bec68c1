"""Numerical operators: frequency plans, dispersion, RHS, integrators and the
CUDA kernel module."""
