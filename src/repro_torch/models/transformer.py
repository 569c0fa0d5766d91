"""Decoder-only LM of the dense / moe / ssm / hybrid / vlm families (port
of `repro.models.transformer`: the forward and loss of training, and the
decode step).

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
  pattern : one kind a character of `layer_pattern` x 1: "M" ssm, "E"
            "moe_only" (a MoE with no attention), "*" "attn_only"
            (attention with no MLP), each x + mixer(rms_norm(x, ln1))

The reference stacks every position's parameters on a leading
(n_supers,) axis and scans it with `lax.scan`; here each layer is one
module (`blocks.{i}`, i = super * per + position, where `per` counts the
positions other than "shared"; the shared block is `shared`) and the scan
is a Python loop.  Parameters are trainable `nn.Parameter`s in
`param_dtype`.  Training casts each matmul weight to the compute `dtype`
at its use, as the reference's `w.astype(x.dtype)` does, so gradients
land in the `param_dtype` masters; with `cfg.remat` each super-block is
recomputed in backward (`torch.utils.checkpoint`, the reference's
`jax.checkpoint`).  The decode step reads a compute-dtype copy of the
weights, cast when it is first needed and cast again after any in-place
change of a parameter (an optimizer step, a restore); training drops it.

The decode cache has the reference's stacked layout: `b{j}` for each
super-block position j, every leaf with a leading (n_supers,) axis, and
`decode_step` updates it in place.

With `tie_embeddings=False` the model holds an output head of its own
(`head`, (V, D)), which the decode step's logits and the loss read.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..device import resolve_device
from ..runtime.sharding import (constrain, is_dtensor, reduce_partial,
                                replicated, replicated_like)
from .attention import (ATTENTION_AXES, attention_apply, attention_init,
                        cross_attention)
from .common import Initializer, ModelConfig
from .layers import (MLP_AXES, chunked_softmax_xent, logits_last, mlp_apply,
                     mlp_init,
                     rms_norm)
from .moe import MOE_AXES, moe_apply, moe_init
from .ssm import (SSM_AXES, ssm_apply, ssm_decode_step, ssm_init,
                  ssm_init_cache)
from .threefry import ReferenceInitializer

# weights used in the compute dtype (the reference's `.astype(x.dtype)`);
# norms, the SSM's A_log / D / dt_bias and the cross gate keep param_dtype
COMPUTE_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "w1", "w2", "w3", "router", "wz", "wx", "wB",
    "wC", "wdt", "out", "conv_x", "conv_B", "conv_C", "conv_x_bias",
    "conv_B_bias", "conv_C_bias"})

# a `layer_pattern` character's block kind
PATTERN_KINDS = {"M": "ssm", "E": "moe_only", "*": "attn_only"}


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
    if fam == "pattern":
        return [PATTERN_KINDS[c] for c in cfg.layer_pattern]
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
    if kind == "moe_only":
        return {**ln, **_prefixed("moe", moe_init(ini, cfg))}
    if kind == "attn_only":
        return {**ln, **_prefixed("attn", attention_init(ini, cfg))}
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
    values), one layer at a time.  On the "meta" device: the shapes
    only."""
    return dict(iter_lm(cfg, generator, device))


def iter_lm(cfg: ModelConfig, generator: torch.Generator | None,
            device="cuda"):
    """`init_lm`'s (name, tensor) pairs in its order, drawn one layer at a
    time as they are asked for (placing a model on a mesh keeps each
    rank's shard of a layer and lets the rest go)."""
    ini = Initializer(generator, resolve_device(device), cfg.param_dtype)
    spec = super_block_spec(cfg)
    per = len([k for k in spec if k != "shared"])
    yield "embed", ini.normal((cfg.vocab, cfg.d_model), scale=0.02)
    yield "final_ln", ini.ones((cfg.d_model,))
    if not cfg.tie_embeddings:
        yield "head", ini.normal((cfg.vocab, cfg.d_model), scale=0.02)
    for s in range(n_supers(cfg)):
        for j, kind in enumerate(spec):
            if kind != "shared":
                yield from _prefixed(f"blocks.{s * per + j}",
                                     _block_init(ini, cfg, kind)).items()
    if "shared" in spec:
        yield from _prefixed("shared", _block_init(ini, cfg, "dense")).items()


def init_lm_reference(cfg: ModelConfig, seed: int,
                      device="cuda") -> dict[str, torch.Tensor]:
    """The reference's initial parameters for `jax.random.key(seed)`
    (`repro.models.transformer.init_lm`) as the port's state dict, drawn
    in torch on `device` by `threefry.ReferenceInitializer` in the
    reference's order: the embedding, then each super-block position's
    parameters for all super-blocks at once (one draw with a leading
    (n_supers,) axis, unbound here into the layers), then the shared
    block."""
    ini = ReferenceInitializer(seed, resolve_device(device),
                               cfg.param_dtype)
    spec = super_block_spec(cfg)
    per = len([k for k in spec if k != "shared"])
    params = {"embed": ini.normal((cfg.vocab, cfg.d_model), scale=0.02),
              "final_ln": ini.ones((cfg.d_model,))}
    for j, kind in enumerate(spec):
        if kind == "shared":
            continue
        stacked = _block_init(ini.stacked(n_supers(cfg)), cfg, kind)
        for name, t in stacked.items():
            for s, layer in enumerate(t.unbind(0)):
                params[f"blocks.{s * per + j}.{name}"] = layer
    if "shared" in spec:
        params.update(_prefixed("shared", _block_init(ini, cfg, "dense")))
    return params


# logical axes of a block's parameters, by their names in the block
BLOCK_AXES = {"ln1": ("embed",), "ln2": ("embed",), "gate": (),
              **_prefixed("attn", ATTENTION_AXES),
              **_prefixed("xattn", ATTENTION_AXES),
              **_prefixed("mlp", MLP_AXES), **_prefixed("moe", MOE_AXES),
              **_prefixed("ssm", SSM_AXES)}


def lm_param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """{state-dict name: logical axes} of `init_lm`'s parameters: the
    reference's axes tree (`init_lm(...)[1]`) with the stacked "layers"
    axis dropped, keyed as the port's state dict."""
    top = {"embed": ("vocab", "embed"), "final_ln": ("embed",),
           "head": ("vocab", "embed")}
    out = {}
    for key in init_lm(cfg, None, "meta"):
        head, _, rest = key.partition(".")
        if key in top:
            out[key] = top[key]
        else:
            out[key] = BLOCK_AXES[rest.partition(".")[2] if head == "blocks"
                                  else rest]
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Stacked decode cache: per super-block position `b{j}`, {"attn":
    {k, v}} (each (n_supers, B, max_len, Hkv, hd) in the compute dtype)
    for dense, moe, shared and attn_only blocks, {"ssm": {conv_x, conv_B,
    conv_C, h}} (float32, leading (n_supers, B)) for ssm blocks, {} for
    cross and moe_only blocks."""
    ns = n_supers(cfg)
    shape = (ns, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {}
    for j, kind in enumerate(super_block_spec(cfg)):
        if kind in ("dense", "moe", "shared", "attn_only"):
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
    """Trainable parameters from a flat state dict: a key "a.b" becomes
    the parameter `b` of the submodule `a`, so the state dict's names are
    the flat keys."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        groups: dict[str, dict] = {}
        for key, t in params.items():
            head, _, rest = key.partition(".")
            if rest:
                groups.setdefault(head, {})[rest] = t
            else:
                self.register_parameter(head, nn.Parameter(t))
        for head, sub in groups.items():
            self.add_module(head, ParamTree(sub))

    def weights(self, dtype) -> dict:
        """The nested dict of this tree's tensors, COMPUTE_WEIGHTS cast to
        `dtype` (under autograd: the cast is part of the graph)."""
        out = {name: (p.to(dtype) if name in COMPUTE_WEIGHTS else p)
               for name, p in self.named_parameters(recurse=False)}
        out.update({name: m.weights(dtype)
                    for name, m in self.named_children()})
        return out


def _subtree(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


class DecoderLM(nn.Module):
    """The decoder: embedding (tied with the output head unless the
    config unties it: `head`), one ParamTree per layer (`blocks`), the
    hybrid's `shared` block and a final norm.
    The counterpart of the reference's `Model`: `loss(batch)`,
    `forward(batch)`, `init_cache`, `decode_step`, with the weights held
    by the module instead of passed in."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.config = cfg
        self.spec = super_block_spec(cfg)
        self.per = len([k for k in self.spec if k != "shared"])
        self.embed = nn.Parameter(params["embed"])
        self.final_ln = nn.Parameter(params["final_ln"])
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(params["head"])
        self.blocks = nn.ModuleList([
            ParamTree(_subtree(params, f"blocks.{i}."))
            for i in range(cfg.n_layers)])
        if "shared" in self.spec:
            self.shared = ParamTree(_subtree(params, "shared."))
        self._decode = None             # (parameter versions, weights)

    def decode_weights(self) -> dict:
        """The weights the decode step reads, in the compute dtype (the
        parameters themselves where `param_dtype` is the compute dtype):
        cast once and kept until a parameter changes in place."""
        versions = tuple((p.to_local() if is_dtensor(p) else p)._version
                         for p in self.parameters())
        if self._decode is None or self._decode[0] != versions:
            self._decode = None
            dt = self.config.dtype
            with torch.no_grad():
                emb = self.embed.detach().to(dt)
                self._decode = (versions, {
                    "embed": emb,
                    "head": (emb if self.config.tie_embeddings
                             else self.head.detach().to(dt)),
                    "blocks": [blk.weights(dt) for blk in self.blocks],
                    "shared": (self.shared.weights(dt)
                               if "shared" in self.spec else None)})
        return self._decode[1]

    @property
    def out_head(self):
        """The output head's (V, D) weight: `head`, or the embedding."""
        return self.embed if self.config.tie_embeddings else self.head

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.config, batch, max_len, self.embed.device)

    def _block(self, kind, w, x, *, positions, image_embeds, cache=None,
               s=0, index=0):
        """One block; returns (x, aux loss or None).  With `cache` (the
        super-block position's stacked cache, read at super-block `s`):
        the decode path at position `index`."""
        cfg = self.config
        if kind == "ssm":
            h = rms_norm(x, w["ln1"], cfg.norm_eps)
            if cache is None:
                return x + ssm_apply(w["ssm"], cfg, h), None
            state = {k: v[s] for k, v in cache["ssm"].items()}
            return x + ssm_decode_step(w["ssm"], cfg, h, state), None
        if kind == "moe_only":
            y, aux = moe_apply(w["moe"], cfg,
                                rms_norm(x, w["ln1"], cfg.norm_eps))
            return x + y, aux
        if kind == "cross":
            h = cross_attention(w["xattn"], cfg,
                                rms_norm(x, w["ln1"], cfg.norm_eps),
                                kv_x=image_embeds)
            x = x + torch.tanh(w["gate"]).to(x.dtype) * h
            return x + mlp_apply(w["mlp"],
                                 rms_norm(x, w["ln2"], cfg.norm_eps),
                                 cfg.mlp_act), None
        kv = None
        if cache is not None:
            kv = {"k": cache["attn"]["k"][s], "v": cache["attn"]["v"][s]}
        x = x + attention_apply(w["attn"], cfg,
                                rms_norm(x, w["ln1"], cfg.norm_eps),
                                positions=positions, cache=kv,
                                cache_index=index, rope=cfg.rope)
        if kind == "attn_only":
            return x, None
        h2 = rms_norm(x, w["ln2"], cfg.norm_eps)
        if kind == "moe":
            y, aux = moe_apply(w["moe"], cfg, h2)
            return x + y, aux
        return x + mlp_apply(w["mlp"], h2, cfg.mlp_act), None

    def _layer_weights(self, s: int, j: int, kind: str):
        if kind == "shared":
            return self.shared, "dense"
        return self.blocks[s * self.per + j], kind

    def _super(self, s: int, x, aux, *, positions, image_embeds):
        """Super-block `s` of the training forward: (x, aux) -> (x, aux)."""
        for j, kind in enumerate(self.spec):
            tree, kind = self._layer_weights(s, j, kind)
            x, a = self._block(kind, tree.weights(x.dtype), x,
                               positions=positions,
                               image_embeds=image_embeds)
            if a is not None:
                aux = aux + a
        return constrain(x, ("batch", "seq", "embed")), aux

    def _inputs(self, batch: dict):
        dev = self.embed.device
        out = {"tokens": torch.as_tensor(batch["tokens"], device=dev).long()}
        if "labels" in batch:
            out["labels"] = torch.as_tensor(batch["labels"],
                                            device=dev).long()
        if batch.get("image_embeds") is not None:
            out["image_embeds"] = torch.as_tensor(batch["image_embeds"],
                                                  device=dev)
        return out

    def hidden(self, tokens, image_embeds=None):
        """tokens (B, S) -> final hidden states (B, S, D) in the compute
        dtype and the MoE aux loss (float32 scalar).  `image_embeds`
        (B, n_image, D) reach the vlm's cross blocks as given (float32
        K/V under a bf16 config, as the reference promotes them)."""
        cfg = self.config
        if torch.is_grad_enabled():
            self._decode = None
        # F.embedding: its gradient sums a repeated token's rows in a
        # fixed order (indexing's would scatter-add them)
        x = F.embedding(tokens, self.embed.to(cfg.dtype))
        # on a mesh: the lookup in a vocab-sharded table is partial
        x = constrain(reduce_partial(x), ("batch", "seq", "embed"))
        positions = replicated_like(
            torch.arange(tokens.shape[1], device=x.device)[None, :], x)
        aux = replicated_like(
            torch.zeros((), dtype=torch.float32, device=x.device), x)
        remat = cfg.remat and torch.is_grad_enabled()
        for s in range(n_supers(cfg)):
            body = functools.partial(self._super, s, positions=positions,
                                     image_embeds=image_embeds)
            x, aux = (checkpoint(body, x, aux, use_reentrant=False) if remat
                      else body(x, aux))
        return rms_norm(x, self.final_ln, cfg.norm_eps), aux

    def forward(self, batch: dict):
        """{tokens, [image_embeds]} -> final hidden states (B, S, D)."""
        b = self._inputs(batch)
        return self.hidden(b["tokens"], b.get("image_embeds"))[0]

    def loss(self, batch: dict):
        """{tokens (B,S), labels (B,S), [image_embeds]} (numpy or tensors)
        -> scalar loss: the mean NLL (chunked over the sequence) plus 0.01
        times the MoE aux loss."""
        b = self._inputs(batch)
        h, aux = self.hidden(b["tokens"], b.get("image_embeds"))
        nll = chunked_softmax_xent(h, self.out_head, b["labels"],
                                   chunk=self.config.xent_chunk)
        return nll + 0.01 * aux

    @obs.span("model.decode_step")
    @torch.no_grad()
    def decode_step(self, token, cache: dict, index: int,
                    image_embeds=None):
        """token (B, 1) int; index: current position; image_embeds
        (B, n_image, D), taken in the compute dtype, for the vlm's cross
        blocks (None: they attend to the token itself, as under the
        reference's launcher).  Updates `cache` in place and returns
        logits (B, V) float32."""
        cfg = self.config
        wts = self.decode_weights()
        emb = wts["embed"]
        if is_dtensor(token):
            # DTensor's lookup of batch-sharded ids in a table sharded on
            # other mesh dims masks the wrong rows: the B ids go whole
            token = token.redistribute(token.device_mesh,
                                       replicated(token))
        x = reduce_partial(F.embedding(token, emb))     # (B, 1, D)
        positions = replicated_like(torch.full(
            (1, 1), index, dtype=torch.int64, device=x.device), x)
        if image_embeds is not None:
            image_embeds = image_embeds.to(cfg.dtype)
        for s in range(n_supers(cfg)):
            for j, kind in enumerate(self.spec):
                if kind == "shared":
                    w, kind = wts["shared"], "dense"
                else:
                    w = wts["blocks"][s * self.per + j]
                x, _ = self._block(kind, w, x, positions=positions,
                                   image_embeds=image_embeds,
                                   cache=cache[f"b{j}"], s=s, index=index)
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        return logits_last(x[:, 0], wts["head"])


def lm_forward(model: DecoderLM, tokens, image_embeds=None):
    """Functional alias of `DecoderLM.hidden`: (h, aux)."""
    return model.hidden(tokens, image_embeds)


def lm_loss(model: DecoderLM, batch: dict):
    """Functional alias of `DecoderLM.loss`."""
    return model.loss(batch)


def lm_decode_step(model: DecoderLM, token, cache: dict, index: int,
                   image_embeds=None):
    """Functional alias of `DecoderLM.decode_step`."""
    return model.decode_step(token, cache, index, image_embeds=image_embeds)
