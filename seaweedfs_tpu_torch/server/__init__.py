"""Serving seams of the port: the lookup gate (the servers come later)."""
