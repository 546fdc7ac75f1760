"""Optimizer plane of the port: AdamW with global-norm clipping, and int8
gradient compression over the emulated node axis."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .compress import compress_int8, compressed_psum, decompress_int8

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_int8", "compressed_psum", "decompress_int8"]
