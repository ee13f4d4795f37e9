"""Data helpers of the port (numpy copies of the JAX package's numpy-only modules)."""
