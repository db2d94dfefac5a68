"""Data helpers of the port (byte-level text encoding)."""
