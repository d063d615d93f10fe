"""Data pipeline of the port (see ``repro.data`` for the reference)."""
