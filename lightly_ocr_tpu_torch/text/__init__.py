"""Label converters (copied from the JAX package; framework-free)."""
