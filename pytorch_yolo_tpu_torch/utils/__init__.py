"""Plain-Python helpers carried over from the JAX package."""
