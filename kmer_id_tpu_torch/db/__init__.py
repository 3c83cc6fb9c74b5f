"""Copies of the JAX package's probe-DB modules (metadata, packed artifact, fingerprint tables)."""
