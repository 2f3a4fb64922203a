"""Pallas kernels and route dispatch for SpMM."""
