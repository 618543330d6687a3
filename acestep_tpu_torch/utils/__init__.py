"""Utilities of the port that need neither the card nor JAX."""
