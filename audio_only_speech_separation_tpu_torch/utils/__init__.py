"""Registry, weight import from the JAX package, inference helpers."""
