"""Checkpoints with the CRAM line codec, in the reference's on-disk format
(port of `repro.checkpoint`)."""

from .ckpt import (CheckpointManager, latest_step, load_checkpoint,
                   save_checkpoint)
from .codec import cram_compress_bytes, cram_decompress_bytes

__all__ = [
    "CheckpointManager", "save_checkpoint", "load_checkpoint",
    "latest_step", "cram_compress_bytes", "cram_decompress_bytes",
]
