"""Copies of the JAX package's read IO (parsers, batcher, native decoder)."""
