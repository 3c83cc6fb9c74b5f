"""Copies of the JAX package's host-side core modules (codec, taxonomy, trim)."""
