"""repro_torch — the PyTorch / CUDA port of the CRAM system.

Mirrors the module layout of the JAX package `repro` (the reference) for
what it covers: the serve launcher's main path (the decoder families,
the continuous-batching serve tier with its compressed spill tier and
the AutoTuner, the CRAM-KV cache), the training path (forward and loss,
AdamW, the data pipeline, CRAM checkpoints, the restart loop), the line
codecs with the compressibility scan, the trace simulator, and their
kernels, hand-written in CUDA C++ for Hopper (`csrc/`).  Every entry
point takes a `device=` that defaults to `"cuda"`; the CPU runs the
kernels' plain PyTorch versions and is what the parity tests use.

This package imports neither `jax` nor anything of `repro`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
