"""Utilities: weights across from the JAX package (``port_jax``)."""
