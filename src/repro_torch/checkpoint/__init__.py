"""PostSI-committed checkpoints of the PyTorch port (``postsi_store``)."""
from .postsi_store import PostSICheckpointer, reshard_tree

__all__ = ["PostSICheckpointer", "reshard_tree"]
