"""Data plane of the port: the checkpointable synthetic token stream."""
from .pipeline import TokenStream

__all__ = ["TokenStream"]
