"""Serving of the port: the slot engine over the decoder."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
