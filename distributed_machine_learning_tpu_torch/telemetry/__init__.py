"""Metrics of the port (stdlib only)."""
