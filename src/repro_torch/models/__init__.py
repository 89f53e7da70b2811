"""Towers that compute user representations (the recsys family)."""
