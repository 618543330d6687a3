"""Serving entry points of the port (the rest of the JAX package's serving
layer is still to be ported)."""
