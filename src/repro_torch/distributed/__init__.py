"""Distributed pieces of the port (the single-device decode reference)."""
