"""Serving (autoregressive generation) of the port."""
