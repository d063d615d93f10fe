"""Checkpointing of the port (see ``repro.ckpt`` for the reference)."""
