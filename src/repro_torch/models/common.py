"""Model configuration (port of `repro.models.common`, the fields the dense
decoder uses).  dtypes are torch dtypes: parameters are stored in
`param_dtype` (float32) and cast to the compute `dtype` (bf16) at use."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0       # 0 -> d_model // n_heads
    mlp_act: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16        # activation / compute dtype
    param_dtype: Any = torch.float32   # parameter storage dtype
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    max_seq: int = 4096

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduce a dense config to CPU-smoke size, as the reference does
    (the other families' reductions come with their port)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: not ported yet")
    return cfg.replace(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4),
        head_dim=32,
        d_ff=256,
        vocab=512,
        dtype=torch.float32,
        param_dtype=torch.float32,
        attn_q_chunk=64,
        attn_k_chunk=64,
        max_seq=128,
    )
