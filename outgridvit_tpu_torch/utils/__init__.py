"""Utilities: weights across from the JAX package (``port_jax``), the
config reader (``config``) and the training history (``history``)."""
