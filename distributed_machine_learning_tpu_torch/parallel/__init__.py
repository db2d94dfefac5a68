"""Gradient synchronization across ranks."""
