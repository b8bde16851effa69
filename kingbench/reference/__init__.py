"""The plain reference that decides ``correct``.  It imports neither the
port nor the JAX package."""
