"""Decoder-only LM of the dense / moe / ssm / hybrid / vlm families (port
of `repro.models.transformer`, the decode path).

The layer stack is `n_supers` repetitions of a super-block (a short list
of block kinds), as in the reference:

  dense   : ["dense"]                        x n_layers
  moe     : ["dense"]*(moe_every-1)+["moe"]  x n_layers/moe_every
  ssm     : ["ssm"]                          x n_layers
  hybrid  : ["ssm"]*attn_every + ["shared"]  x n_layers/attn_every
            ("shared" = one dense block whose weights every super-block
             uses, with a KV cache of its own in each)
  vlm     : ["dense"]*(cross_every-1)+["cross"] x n_layers/cross_every
            ("cross" = cross-attention to the image embeddings + MLP)

The reference stacks every position's parameters on a leading
(n_supers,) axis and scans it with `lax.scan`; here each layer is one
module (`blocks.{i}`, i = super * per + position, where `per` counts the
positions other than "shared"; the shared block is `shared`) and the scan
is a Python loop.  Each matmul weight is used in the compute `dtype`, as
the reference's `w.astype(x.dtype)` does, through a copy cast once at load
time (the cast is deterministic, so the copy has the same bits; where
`param_dtype` is the compute dtype there is no copy).

The decode cache has the reference's stacked layout: `b{j}` for each
super-block position j, every leaf with a leading (n_supers,) axis, and
`decode_step` updates it in place.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import attention_apply, attention_init, cross_attention
from .common import Initializer, ModelConfig
from .layers import logits_last, mlp_apply, mlp_init, rms_norm
from .moe import moe_apply, moe_init
from .ssm import ssm_decode_step, ssm_init, ssm_init_cache

# weights used in the compute dtype (the reference's `.astype(x.dtype)`);
# norms, the SSM's A_log / D / dt_bias and the cross gate keep param_dtype
COMPUTE_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "w1", "w2", "w3", "router", "wz", "wx", "wB",
    "wC", "wdt", "out", "conv_x", "conv_B", "conv_C"})


def super_block_spec(cfg: ModelConfig) -> list[str]:
    fam = cfg.family
    if fam == "dense":
        return ["dense"]
    if fam == "moe":
        k = max(cfg.moe_every, 1)
        return ["dense"] * (k - 1) + ["moe"]
    if fam == "ssm":
        return ["ssm"]
    if fam == "hybrid":
        return ["ssm"] * max(cfg.attn_every, 1) + ["shared"]
    if fam == "vlm":
        k = max(cfg.cross_attn_every, 1)
        return ["dense"] * (k - 1) + ["cross"]
    raise ValueError(f"unknown family {fam!r}")


def n_supers(cfg: ModelConfig) -> int:
    spec = super_block_spec(cfg)
    per = len([k for k in spec if k != "shared"])
    assert cfg.n_layers % per == 0, (cfg.n_layers, spec)
    return cfg.n_layers // per


def _prefixed(prefix: str, params: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in params.items()}


def _block_init(ini, cfg: ModelConfig, kind: str) -> dict:
    ln = {"ln1": ini.ones((cfg.d_model,))}
    if kind == "ssm":
        return {**ln, **_prefixed("ssm", ssm_init(ini, cfg))}
    attn = "xattn" if kind == "cross" else "attn"
    p = {**ln, **_prefixed(attn, attention_init(ini, cfg))}
    if kind == "cross":
        p["gate"] = ini.zeros(())
    p["ln2"] = ini.ones((cfg.d_model,))
    if kind == "moe":
        p.update(_prefixed("moe", moe_init(ini, cfg)))
    elif kind in ("dense", "cross"):
        p.update(_prefixed("mlp", mlp_init(ini, cfg.d_model, cfg.d_ff,
                                           cfg.mlp_act)))
    else:
        raise ValueError(kind)
    return p


def init_lm(cfg: ModelConfig, generator: torch.Generator | None,
            device="cuda") -> dict[str, torch.Tensor]:
    """Random parameters as a state dict, drawn on `device` from
    `generator` (a generator of that device) with the reference's scales
    (normal / sqrt(fan_in), the embedding and router at 0.02, norms at
    one, the SSM's constants and the cross gate at the reference's
    values).  On the "meta" device: the shapes only."""
    ini = Initializer(generator, resolve_device(device), cfg.param_dtype)
    spec = super_block_spec(cfg)
    per = len([k for k in spec if k != "shared"])
    params = {"embed": ini.normal((cfg.vocab, cfg.d_model), scale=0.02),
              "final_ln": ini.ones((cfg.d_model,))}
    for s in range(n_supers(cfg)):
        for j, kind in enumerate(spec):
            if kind != "shared":
                params.update(_prefixed(f"blocks.{s * per + j}",
                                        _block_init(ini, cfg, kind)))
    if "shared" in spec:
        params.update(_prefixed("shared", _block_init(ini, cfg, "dense")))
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Stacked decode cache: per super-block position `b{j}`, {"attn":
    {k, v}} (each (n_supers, B, max_len, Hkv, hd) in the compute dtype)
    for dense, moe and shared blocks, {"ssm": {conv_x, conv_B, conv_C,
    h}} (float32, leading (n_supers, B)) for ssm blocks, {} for cross
    blocks."""
    ns = n_supers(cfg)
    shape = (ns, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {}
    for j, kind in enumerate(super_block_spec(cfg)):
        if kind in ("dense", "moe", "shared"):
            cache[f"b{j}"] = {"attn": {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}}
        elif kind == "ssm":
            cache[f"b{j}"] = {"ssm": ssm_init_cache(cfg, batch, device,
                                                    lead=(ns,))}
        else:
            cache[f"b{j}"] = {}
    return cache


class ParamTree(nn.Module):
    """Frozen parameters from a flat state dict: a key "a.b" becomes the
    parameter `b` of the submodule `a`, so the state dict's names are the
    flat keys."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        groups: dict[str, dict] = {}
        for key, t in params.items():
            head, _, rest = key.partition(".")
            if rest:
                groups.setdefault(head, {})[rest] = t
            else:
                self.register_parameter(
                    head, nn.Parameter(t, requires_grad=False))
        for head, sub in groups.items():
            self.add_module(head, ParamTree(sub))

    def compute(self, dtype) -> dict:
        """The nested dict of this tree's tensors, COMPUTE_WEIGHTS cast to
        `dtype`."""
        out = {name: (p.detach().to(dtype) if name in COMPUTE_WEIGHTS
                      else p.detach())
               for name, p in self.named_parameters(recurse=False)}
        out.update({name: m.compute(dtype)
                    for name, m in self.named_children()})
        return out


def _subtree(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


class DecoderLM(nn.Module):
    """The decoder: embedding (tied with the output head), one ParamTree
    per layer (`blocks`), the hybrid's `shared` block and a final norm."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.config = cfg
        self.spec = super_block_spec(cfg)
        self.per = len([k for k in self.spec if k != "shared"])
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_ln = nn.Parameter(params["final_ln"], requires_grad=False)
        self.blocks = nn.ModuleList([
            ParamTree(_subtree(params, f"blocks.{i}."))
            for i in range(cfg.n_layers)])
        if "shared" in self.spec:
            self.shared = ParamTree(_subtree(params, "shared."))
        dt = cfg.dtype
        self._compute = {
            "embed": self.embed.detach().to(dt),
            "blocks": [blk.compute(dt) for blk in self.blocks],
            "shared": self.shared.compute(dt) if "shared" in self.spec
            else None}

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.config, batch, max_len, self.embed.device)

    def _block(self, kind, w, x, cache, s, positions, index, image_embeds):
        cfg = self.config
        if kind == "ssm":
            state = {k: v[s] for k, v in cache["ssm"].items()}
            return x + ssm_decode_step(w["ssm"], cfg, rms_norm(x, w["ln1"]),
                                       state)
        if kind == "cross":
            h = cross_attention(w["xattn"], cfg, rms_norm(x, w["ln1"]),
                                kv_x=image_embeds)
            x = x + torch.tanh(w["gate"]).to(x.dtype) * h
            return x + mlp_apply(w["mlp"], rms_norm(x, w["ln2"]),
                                 cfg.mlp_act)
        kv = cache["attn"]
        x = x + attention_apply(
            w["attn"], cfg, rms_norm(x, w["ln1"]), positions=positions,
            cache={"k": kv["k"][s], "v": kv["v"][s]}, cache_index=index)
        h2 = rms_norm(x, w["ln2"])
        if kind == "moe":
            return x + moe_apply(w["moe"], cfg, h2)[0]
        return x + mlp_apply(w["mlp"], h2, cfg.mlp_act)

    @torch.no_grad()
    def decode_step(self, token, cache: dict, index: int,
                    image_embeds=None):
        """token (B, 1) int; index: current position; image_embeds
        (B, n_image, D), taken in the compute dtype, for the vlm's cross
        blocks (None: they attend to the token itself, as under the
        reference's launcher).  Updates `cache` in place and returns
        logits (B, V) float32."""
        cfg = self.config
        emb = self._compute["embed"]
        x = emb[token]                                   # (B, 1, D)
        positions = torch.full((1, 1), index, dtype=torch.int64,
                               device=x.device)
        if image_embeds is not None:
            image_embeds = image_embeds.to(cfg.dtype)
        for s in range(n_supers(cfg)):
            for j, kind in enumerate(self.spec):
                if kind == "shared":
                    w, kind = self._compute["shared"], "dense"
                else:
                    w = self._compute["blocks"][s * self.per + j]
                x = self._block(kind, w, x, cache[f"b{j}"], s, positions,
                                index, image_embeds)
        x = rms_norm(x, self.final_ln)
        return logits_last(x[:, 0], emb)


def lm_decode_step(model: DecoderLM, token, cache: dict, index: int,
                   image_embeds=None):
    """Functional alias of `DecoderLM.decode_step`."""
    return model.decode_step(token, cache, index, image_embeds=image_embeds)
