"""Data pipeline: deterministic synthetic LM streams, sharded per host
(port of `repro.data`)."""

from .pipeline import DataConfig, SyntheticLM, make_batch_iterator

__all__ = ["DataConfig", "SyntheticLM", "make_batch_iterator"]
