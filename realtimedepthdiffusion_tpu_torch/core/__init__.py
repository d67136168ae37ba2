"""Plain torch counterparts of the JAX package's core modules."""
