"""Named configuration variants of a cell (port of
`repro.launch.variants`).

A variant is (config transform, sharding-rule override, step options)
applied on top of an architecture's base config; `+` composes them left
to right ("no_fsdp+bf16_params+mb2").  Four take a number: `mb<n>`
(microbatches), `qc<n>` / `kc<n>` (the attention's q and k chunks) and
`xent<n>` (the cross-entropy chunk).

Options:
  fsdp: bool — shard the parameters over the data axis too (default
    True; `build_cell(..., fsdp=...)`).
  donate_cache: bool — the reference's decode aliases the KV cache in
    and out; the port's decode step always writes its cache in place, so
    the option is kept for the reference's variant names and changes
    nothing here.
"""

from __future__ import annotations

import torch

from ..runtime.sharding import RuleSet


def apply_variant(cfg, shape, variant: str):
    """Returns (cfg, rules, opts) for the named variant."""
    rules = RuleSet()
    opts: dict = {}
    for part in variant.split("+"):
        cfg, rules, opts = _apply_one(cfg, rules, opts, part)
    return cfg, rules, opts


def _apply_one(cfg, rules, opts, v: str):
    if v == "base":
        return cfg, rules, opts
    if v == "no_remat":
        return cfg.replace(remat=False), rules, opts
    if v == "attn_gather":   # one seq-gather per attention (Megatron-SP)
        return cfg.replace(attn_gather=True), rules, opts
    if v == "donate":        # decode: the cache in place (always, here)
        return cfg, rules, {**opts, "donate_cache": True}
    if v == "no_fsdp":       # params TP-sharded only: no per-layer gathers
        return cfg, rules, {**opts, "fsdp": False}
    if v == "bf16_params":   # halve FSDP gather + grad reduce bytes
        return cfg.replace(param_dtype=torch.bfloat16), rules, opts
    if v == "bf16_opt":
        return cfg.replace(optimizer_dtype=torch.bfloat16), rules, opts
    if v.startswith("mb"):   # microbatch count, e.g. mb1 / mb2 / mb8
        return cfg.replace(microbatches=int(v[2:])), rules, opts
    if v.startswith("qc"):
        return cfg.replace(attn_q_chunk=int(v[2:])), rules, opts
    if v.startswith("kc"):
        return cfg.replace(attn_k_chunk=int(v[2:])), rules, opts
    if v.startswith("xent"):
        return cfg.replace(xent_chunk=int(v[4:])), rules, opts
    if v == "no_sp":         # activations keep full sequence (no SP)
        return cfg, rules.override(seq=()), opts
    if v == "sp_data":       # shard activation seq over data instead
        return cfg, rules.override(seq=("data",)), opts
    if v == "kv_seq_replicated":  # decode: no sequence-parallel KV
        return cfg, rules.override(kv_seq=()), opts
    if v == "kv_seq_model":  # decode: KV sequence over the model axis
        return cfg, rules.override(kv_seq=("model",)), opts
    if v == "batch_model":   # decode: spread batch over model too
        return cfg, rules.override(batch=("pod", "data", "model")), opts
    if v == "embed_shard":   # Megatron-SP on the hidden dim
        return cfg, rules.override(embed=("model",)), opts
    if v == "expert_data":   # experts sharded over data axis
        return cfg, rules.override(experts=("data",)), opts
    raise KeyError(f"unknown variant {v!r}")
