"""Shared constants of the port's entry points."""

SEED = 69143  # the reference's shared seed (part1/main.py:17)
