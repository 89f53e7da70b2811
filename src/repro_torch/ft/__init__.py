"""Failure injection for the serving tier."""
