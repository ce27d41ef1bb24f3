"""Resilience of the port: the training divergence check."""
