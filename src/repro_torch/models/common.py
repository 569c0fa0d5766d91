"""Model configuration (port of `repro.models.common`: the fields of the
decoder families and of training that the configs set).  dtypes are torch
dtypes: parameters are stored in `param_dtype` and cast to the compute
`dtype` at use."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # dense | moe | ssm | hybrid | encdec | vlm | pattern
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0       # 0 -> d_model // n_heads
    mlp_act: str = "swiglu"  # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True   # False: an output head of its own
    rope: bool = True        # False: attention blocks rotate neither q nor k
    norm_eps: float = 1e-6   # every RMS norm's epsilon
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    moe_every: int = 1          # a MoE MLP every k-th layer (1 = all layers)
    shared_expert_ff: int = 0   # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    # softmax: top-k of the softmax, gates renormalised over the k;
    # sigmoid_bias: top-k of sigmoid scores plus a per-expert bias
    # (`moe.bias`), gates the chosen unbiased scores renormalised
    router: str = "softmax"
    routed_scale: float = 1.0   # the routed experts' sum times this
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_inner: int = 0          # d_inner; 0 -> ssm_expand * d_model
    ssm_norm_groups: int = 1    # the gated norm's groups over d_inner
    ssm_conv_bias: bool = False
    # --- hybrid (zamba2): shared attention block every k ssm layers ---
    attn_every: int = 0
    # --- pattern: one block a character, "M" ssm, "E" MoE with no
    # attention, "*" attention with no MLP (n_layers = its length) ---
    layer_pattern: str = ""
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- vlm ---
    cross_attn_every: int = 0   # a cross-attn layer every k-th layer
    n_image_tokens: int = 0
    # --- numerics / training ---
    dtype: Any = torch.bfloat16        # activation / compute dtype
    param_dtype: Any = torch.float32   # parameter storage dtype
    optimizer_dtype: Any = torch.float32  # AdamW moment dtype
    remat: bool = True       # recompute each super-block in backward
    microbatches: int = 4    # grad-accumulation steps per train step
    # the reference's cost-probe and sequence-gather switches, kept for
    # config parity: loops are Python loops here, and one device gathers
    # nothing
    unroll: bool = False
    attn_gather: bool = False
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    xent_chunk: int = 512
    max_seq: int = 4096

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_inner or self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduce a config to CPU-smoke size, keeping the family and every
    structural feature (GQA ratio, MoE, hybrid pattern, encoder and
    decoder stacks...), as the reference does."""
    kw: dict[str, Any] = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4),
        head_dim=32,
        d_ff=256,
        vocab=512,
        dtype=torch.float32,
        param_dtype=torch.float32,
        remat=False,
        attn_q_chunk=64,
        attn_k_chunk=64,
        xent_chunk=64,
        max_seq=128,
    )
    if cfg.family == "moe":
        layers = max(2, 2 * max(cfg.moe_every, 1))
        kw.update(n_layers=layers, n_experts=min(cfg.n_experts, 8),
                  top_k=min(cfg.top_k, 4), d_ff=64,
                  shared_expert_ff=64 if cfg.shared_expert_ff else 0)
    elif cfg.family == "ssm":
        kw.update(n_layers=2, ssm_state=min(cfg.ssm_state, 32),
                  ssm_headdim=32, ssm_chunk=32)
    elif cfg.family == "hybrid":
        kw.update(n_layers=2 * max(cfg.attn_every, 1),
                  ssm_state=min(cfg.ssm_state, 32), ssm_headdim=32,
                  ssm_chunk=32, attn_every=max(cfg.attn_every, 1))
    elif cfg.family == "pattern":
        # every kind of block once, in the order the pattern first has it
        pattern = "".join(sorted(set(cfg.layer_pattern),
                                 key=cfg.layer_pattern.index))
        kw.update(n_layers=len(pattern), layer_pattern=pattern,
                  n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 4),
                  d_ff=64, shared_expert_ff=64 if cfg.shared_expert_ff else 0,
                  ssm_state=min(cfg.ssm_state, 32), ssm_headdim=32,
                  ssm_chunk=32, ssm_inner=0,
                  ssm_ngroups=min(cfg.ssm_ngroups, 2),
                  ssm_norm_groups=min(cfg.ssm_norm_groups, 2))
    elif cfg.family == "encdec":
        kw.update(enc_layers=2, dec_layers=2, n_layers=2)
    elif cfg.family == "vlm":
        kw.update(n_layers=2 * max(cfg.cross_attn_every, 1),
                  cross_attn_every=max(cfg.cross_attn_every, 1),
                  n_image_tokens=16)
    else:
        kw.update(n_layers=2)
    return cfg.replace(**kw)


class Initializer:
    """Draws a block's parameters with the reference's scales (normal /
    sqrt(fan_in) unless a scale is given, ones, zeros, constants) in
    `param_dtype`, from `generator` on `device`.  Not the reference's
    bits: the tests load converted reference weights instead.

    A normal tensor of three or more axes (the MoE's stacked experts) is
    drawn one leading index at a time, so that the float32 draw stays the
    size of one expert.  On the "meta" device nothing is drawn: the
    shapes alone are what `build` holds given weights against."""

    def __init__(self, generator, device, param_dtype):
        self.generator = generator
        self.device = torch.device(device)
        self.param_dtype = param_dtype

    def _empty(self, shape):
        return torch.empty(shape, dtype=self.param_dtype, device=self.device)

    def _draw(self, shape, scale):
        w = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return (w * scale).to(self.param_dtype)

    def normal(self, shape, scale=None):
        shape = tuple(shape)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        if self.device.type == "meta":
            return self._empty(shape)
        if len(shape) <= 2:
            return self._draw(shape, scale)
        out = self._empty(shape)
        for e in range(shape[0]):
            out[e] = self._draw(shape[1:], scale)
        return out

    def const(self, shape, value: float):
        return torch.full(tuple(shape), value, dtype=self.param_dtype,
                          device=self.device)

    def ones(self, shape):
        return self.const(shape, 1.0)

    def zeros(self, shape):
        return self.const(shape, 0.0)
