"""Weights carried across from the JAX package (``from_jax``)."""
