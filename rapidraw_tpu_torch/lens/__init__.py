"""Lensfun-format lens correction database (copy of the JAX package's)."""
