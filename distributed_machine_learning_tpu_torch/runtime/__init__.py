"""Serving-runtime policy and request records of the port (stdlib only)."""
