"""Copy of the JAX package's report rollups used by mitokmer and readc."""
