"""Copies of the JAX package's logging and stage timers."""
