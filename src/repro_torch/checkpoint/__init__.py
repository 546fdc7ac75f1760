"""PostSI-committed checkpoints of the PyTorch port (``postsi_store``)."""
from .postsi_store import PostSICheckpointer

__all__ = ["PostSICheckpointer"]
