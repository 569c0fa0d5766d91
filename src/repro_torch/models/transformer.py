"""Decoder-only LM, dense family (port of `repro.models.transformer`).

The reference scans a stacked (n_layers, ...) parameter tree with
`lax.scan`; here the model is an `nn.Module` with one block module per
layer and the scan is a Python loop.  Parameters are stored in
`param_dtype` (float32); each weight is used in the compute `dtype`, as
the reference's `w.astype(x.dtype)` does, through a copy cast once at
load time (the cast is deterministic, so the copy has the same bits).

The decode cache mirrors the reference's stacked layout: every leaf has a
leading (n_layers,) axis, and `decode_step` writes the new K/V into it in
place.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from .attention import attention_apply
from .common import ModelConfig
from .layers import logits_last, mlp_apply, rms_norm


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device="cuda") -> dict[str, torch.Tensor]:
    """Random parameters as a state dict, drawn on `device` from
    `generator` (a generator of that device) with the reference's scales
    (normal / sqrt(fan_in), the embedding at 0.02, norms at one).  Not the
    reference's bits: the tests load converted reference weights
    instead."""
    device = resolve_device(device)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def normal(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(cfg.param_dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.param_dtype, device=device)

    params = {"embed": normal(cfg.vocab, d, scale=0.02), "final_ln": ones(d)}
    for i in range(cfg.n_layers):
        blk = {
            "ln1": ones(d), "ln2": ones(d),
            "attn.wq": normal(d, hq * hd), "attn.wk": normal(d, hkv * hd),
            "attn.wv": normal(d, hkv * hd), "attn.wo": normal(hq * hd, d),
            "mlp.w1": normal(d, f), "mlp.w2": normal(f, d),
        }
        if cfg.mlp_act == "swiglu":
            blk["mlp.w3"] = normal(d, f)
        if cfg.qk_norm:
            blk["attn.q_norm"] = ones(hd)
            blk["attn.k_norm"] = ones(hd)
        params.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Stacked decode cache: {"b0": {"attn": {k, v}}}, each leaf
    (n_layers, B, max_len, Hkv, hd) in the compute dtype."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"b0": {"attn": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}}}


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseBlock(nn.Module):
    """One pre-norm block: GQA attention + MLP."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.ln1 = _frozen(params["ln1"])
        self.ln2 = _frozen(params["ln2"])
        self.attn = nn.ParameterDict({
            k[len("attn."):]: _frozen(v) for k, v in params.items()
            if k.startswith("attn.")})
        self.mlp = nn.ParameterDict({
            k[len("mlp."):]: _frozen(v) for k, v in params.items()
            if k.startswith("mlp.")})


class DenseLM(nn.Module):
    """The dense decoder: embedding (tied with the output head), a stack
    of `DenseBlock`s and a final norm."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.config = cfg
        self.embed = _frozen(params["embed"])
        self.final_ln = _frozen(params["final_ln"])
        self.blocks = nn.ModuleList([
            DenseBlock({k[len(f"blocks.{i}."):]: v for k, v in params.items()
                        if k.startswith(f"blocks.{i}.")})
            for i in range(cfg.n_layers)])
        self._compute = self._compute_weights()

    def _compute_weights(self) -> dict:
        """The matmul weights in the compute dtype (the reference casts at
        every use; one cast here gives the same bits)."""
        dt = self.config.dtype

        def cast(p):
            return p.detach().to(dt)

        return {
            "embed": cast(self.embed),
            "blocks": [{"attn": {k: (cast(v) if k.startswith("w") else v)
                                 for k, v in blk.attn.items()},
                        "mlp": {k: cast(v) for k, v in blk.mlp.items()}}
                       for blk in self.blocks],
        }

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.config, batch, max_len, self.embed.device)

    @torch.no_grad()
    def decode_step(self, token, cache: dict, index: int):
        """token (B, 1) int; index: current position.  Writes the step's
        K/V into `cache` in place and returns logits (B, V) float32."""
        cfg = self.config
        emb = self._compute["embed"]
        x = emb[token]                                   # (B, 1, D)
        positions = torch.full((1, 1), index, dtype=torch.int64,
                               device=x.device)
        kc, vc = cache["b0"]["attn"]["k"], cache["b0"]["attn"]["v"]
        for i, blk in enumerate(self.blocks):
            w = self._compute["blocks"][i]
            x = x + attention_apply(
                w["attn"], cfg, rms_norm(x, blk.ln1), positions=positions,
                cache={"k": kc[i], "v": vc[i]}, cache_index=index)
            x = x + mlp_apply(w["mlp"], rms_norm(x, blk.ln2), cfg.mlp_act)
        x = rms_norm(x, self.final_ln)
        return logits_last(x[:, 0], emb)


def lm_decode_step(model: DenseLM, token, cache: dict, index: int):
    """Functional alias of `DenseLM.decode_step`."""
    return model.decode_step(token, cache, index)
