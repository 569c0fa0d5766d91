"""Model construction, the cells' shapes and analytic parameter counts
(port of `repro.models.zoo`: `build`, `ShapeSpec` and `STANDARD_SHAPES`,
`abstract_params` and `param_axes`, `input_specs` and `cache_specs`,
`count_params`, `active_params`).  Shapes come as tensors on the "meta"
device, the port's `jax.ShapeDtypeStruct`: they allocate nothing.  The
reference's `Model` bundles the config with `init`, `loss`, `forward`,
`init_cache` and `decode_step`; here `build` returns a `DecoderLM` (the
decoder families) or a `Whisper` (encdec), which holds its weights and
has `loss(batch)`, `forward(batch)`, `init_cache` and `decode_step`."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .common import ModelConfig
from .transformer import DecoderLM, init_cache, init_lm, lm_param_axes
from .whisper import (Whisper, init_whisper, whisper_init_cache,
                      whisper_param_axes, whisper_shapes)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


STANDARD_SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),  # forward-only
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in STANDARD_SHAPES}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build(cfg: ModelConfig, *, device="cuda", seed: int = 0,
          params: dict[str, torch.Tensor] | None = None
          ) -> DecoderLM | Whisper:
    """The model on `device`: random weights from `seed` (a decoder's
    from a seeded `torch.Generator`, whisper's the reference's draws for
    `jax.random.key(seed)`), or `params` (a state dict, e.g. from
    `repro_torch.convert.params_from_jax` or `init_lm_reference`), which
    must hold exactly the tensors of the family's init, at the same
    shapes."""
    dev = resolve_device(device)
    encdec = cfg.family == "encdec"
    if params is None:
        if encdec:
            params = init_whisper(cfg, seed, dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = init_lm(cfg, gen, dev)
    else:
        want = (whisper_shapes(cfg) if encdec else
                {k: tuple(v.shape)
                 for k, v in init_lm(cfg, None, "meta").items()})
        got = {k: tuple(v.shape) for k, v in params.items()}
        if got != want:
            bad = sorted(k for k in want.keys() | got.keys()
                         if want.get(k) != got.get(k))
            raise ValueError(f"params do not match {cfg.name}'s layout: "
                             + ", ".join(f"{k}: {got.get(k)} (want "
                                         f"{want.get(k)})" for k in bad[:8]))
        params = {k: v.to(device=dev, dtype=cfg.param_dtype)
                  for k, v in params.items()}
    return Whisper(cfg, params) if encdec else DecoderLM(cfg, params)


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """{state-dict name: logical axes} of the model's parameters (the
    reference's `Model.abstract_params()[1]` without the stacked "layers"
    axis, keyed as the port's state dict), for the sharding rules."""
    return (whisper_param_axes(cfg) if cfg.family == "encdec"
            else lm_param_axes(cfg))


def abstract_params(cfg: ModelConfig) -> tuple[dict, dict]:
    """(state dict of meta tensors, `param_axes(cfg)`): the reference's
    `Model.abstract_params()` as a function, keyed as the port's state
    dict (one tensor a layer).  Allocates nothing, so the 123B and 400B
    configs build on any host."""
    if cfg.family == "encdec":
        shapes = {k: _meta(v, cfg.param_dtype)
                  for k, v in whisper_shapes(cfg).items()}
    else:
        shapes = init_lm(cfg, None, "meta")
    return shapes, param_axes(cfg)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors standing in for every model input of this cell, with
    the reference's keys, shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, s), i32)}
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        if cfg.family == "encdec":
            # the decoder teacher-forced over S, the encoder over S frames
            batch["frames"] = _meta((b, s, cfg.d_model), cfg.dtype)
        if cfg.family == "vlm":
            batch["image_embeds"] = _meta((b, cfg.n_image_tokens,
                                           cfg.d_model), cfg.dtype)
        return batch
    # decode: one new token against a seq_len cache
    spec = {"token": _meta((b, 1), i32), "index": _meta((), i32)}
    if cfg.family == "vlm":
        spec["image_embeds"] = _meta((b, cfg.n_image_tokens, cfg.d_model),
                                     cfg.dtype)
    return spec


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The decode cache of this cell as meta tensors (the model's
    `init_cache(global_batch, seq_len)`)."""
    if cfg.family == "encdec":
        return whisper_init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
    return init_cache(cfg, shape.global_batch, shape.seq_len, "meta")


def _mlp(cfg: ModelConfig, d_ff: int) -> int:
    return cfg.d_model * d_ff * (3 if cfg.mlp_act == "swiglu" else 2)


def _attn(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    return d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2


def _ssm_layer(cfg: ModelConfig) -> int:
    d, din = cfg.d_model, cfg.d_inner
    return (d * din * 2 + 2 * d * cfg.ssm_ngroups * cfg.ssm_state
            + d * cfg.ssm_heads + din * d)


def count_params(cfg: ModelConfig) -> int:
    """The reference's analytic count, formula for formula (the embedding
    and the matmul weights; norms, conv weights and the SSM's per-head
    vectors, and whisper's decoder positions, are not counted)."""
    v, d = cfg.vocab, cfg.d_model
    attn, mlp = _attn(cfg), _mlp(cfg, cfg.d_ff)
    if cfg.family == "encdec":
        return (v * d + cfg.enc_layers * (attn + mlp)
                + cfg.dec_layers * (2 * attn + mlp))
    if cfg.family == "ssm":
        return v * d + cfg.n_layers * _ssm_layer(cfg)
    if cfg.family == "hybrid":
        return v * d + cfg.n_layers * _ssm_layer(cfg) + attn + mlp
    if cfg.family == "pattern":
        return _pattern_params(cfg, cfg.n_experts)
    if cfg.family == "moe":
        e_mlp = cfg.n_experts * mlp + d * cfg.n_experts
        n_moe = cfg.n_layers // max(cfg.moe_every, 1)
        return (v * d + cfg.n_layers * attn + (cfg.n_layers - n_moe) * mlp
                + n_moe * (e_mlp + _mlp(cfg, cfg.shared_expert_ff)))
    per = attn + mlp
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // max(cfg.cross_attn_every, 1)
        return v * d + cfg.n_layers * per + n_cross * attn
    return v * d + cfg.n_layers * per


def _pattern_params(cfg: ModelConfig, experts: int) -> int:
    """The pattern family's count with `experts` routed experts a MoE
    block (the untied head counted, as the embedding)."""
    v, d = cfg.vocab, cfg.d_model
    moe = (experts * _mlp(cfg, cfg.d_ff) + d * cfg.n_experts
           + _mlp(cfg, cfg.shared_expert_ff))
    per = {"M": _ssm_layer(cfg), "E": moe, "*": _attn(cfg)}
    head = 0 if cfg.tie_embeddings else v * d
    return v * d + head + sum(per[c] for c in cfg.layer_pattern)


def active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: routed top-k + shared only)."""
    if cfg.family == "pattern":
        return _pattern_params(cfg, cfg.top_k)
    if cfg.family != "moe":
        return count_params(cfg)
    d, mlp = cfg.d_model, _mlp(cfg, cfg.d_ff)
    n_moe = cfg.n_layers // max(cfg.moe_every, 1)
    return (cfg.vocab * d + cfg.n_layers * _attn(cfg)
            + (cfg.n_layers - n_moe) * mlp
            + n_moe * (cfg.top_k * mlp + _mlp(cfg, cfg.shared_expert_ff)
                       + d * cfg.n_experts))
