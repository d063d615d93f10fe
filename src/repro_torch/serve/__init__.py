"""Serving of the port: the slot engine over the decoder."""
from .engine import Request, ServeEngine
from .graph import DecodeGraph

__all__ = ["DecodeGraph", "Request", "ServeEngine"]
