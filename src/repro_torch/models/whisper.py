"""Whisper-style encoder-decoder (port of `repro.models.whisper`).

The audio frontend (log-mel + conv downsampling) is a STUB, as in the
reference: the inputs are precomputed frame embeddings (B, S, d_model),
which the encoder consumes directly (sinusoidal positions, then
bidirectional self-attention without RoPE).  The decoder is a causal
transformer with learned positions (`pos_dec`), no RoPE, and
cross-attention to the encoder's output; its output projection is tied
to the token embedding.  LayerNorm has a bias; the QKV projections have
none.

Parameters are a flat state dict: `embed`, `pos_dec`, and for `enc` and
`dec` one ParamTree a layer (`{enc,dec}.blocks.{i}.*`) and the final norm
(`{enc,dec}.ln.{w,b}`).  The reference stacks each stack's layers on a
leading axis (`enc/blocks/...`, `convert.params_from_jax` unbinds them)
and scans them; here the scan is a Python loop, each block recomputed in
backward under `cfg.remat` (`torch.utils.checkpoint`, the reference's
`jax.checkpoint`).  `init_whisper` draws the reference's weights for
`jax.random.key(seed)` in the reference's order through
`threefry.ReferenceInitializer`.

The decode cache has the reference's layout — self-attention K/V and the
cross-attention K/V (`xk`, `xv`) of every decoder layer, each
(dec_layers, B, T, Hkv, hd) in the compute dtype — and `decode_step`
updates it in place.  `whisper_prefill_cross` fills the cross K/V from
the encoder's output; the reference's launcher, which has no frames,
decodes against the zero cross K/V of `init_cache`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..runtime.sharding import (constrain, is_dtensor, matmul,
                                reduce_partial, reduce_to, replicated,
                                replicated_like)
from .attention import (ATTENTION_AXES, attention_apply, attention_init,
                        chunked_decode_attention, cross_attention,
                        decode_on_shards)
from .common import ModelConfig
from .layers import (MLP_AXES, chunked_softmax_xent, layer_norm,
                     logits_last, mlp_apply, mlp_init, sinusoidal_positions)
from .threefry import ReferenceInitializer
from .transformer import ParamTree, _prefixed, _subtree


def _ln_init(ini, d: int) -> dict:
    return {"w": ini.ones((d,)), "b": ini.zeros((d,))}


def _ln(x, p):
    return layer_norm(x, p["w"], p["b"])


def _enc_block_init(ini, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {**_prefixed("ln1", _ln_init(ini, d)),
            **_prefixed("attn", attention_init(ini, cfg)),
            **_prefixed("ln2", _ln_init(ini, d)),
            **_prefixed("mlp", mlp_init(ini, d, cfg.d_ff, cfg.mlp_act))}


def _dec_block_init(ini, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {**_prefixed("ln1", _ln_init(ini, d)),
            **_prefixed("self", attention_init(ini, cfg)),
            **_prefixed("ln2", _ln_init(ini, d)),
            **_prefixed("cross", attention_init(ini, cfg)),
            **_prefixed("ln3", _ln_init(ini, d)),
            **_prefixed("mlp", mlp_init(ini, d, cfg.d_ff, cfg.mlp_act))}


class _Shapes:
    """An initializer of shapes only (meta tensors), with the reference
    initializer's `stacked` view."""

    def __init__(self, dtype, lead=()):
        self.dtype, self.lead = dtype, lead

    def stacked(self, n: int) -> "_Shapes":
        return _Shapes(self.dtype, (n,))

    def normal(self, shape, scale=None):
        return torch.empty(self.lead + tuple(shape), dtype=self.dtype,
                           device="meta")

    ones = zeros = normal


def _whisper_params(ini, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The state dict, drawn from `ini` in the reference's order: the
    embedding, the decoder positions, each stack's blocks (one draw of
    each leaf with a leading (layers,) axis, unbound here into the
    layers), each stack's final norm."""
    d = cfg.d_model
    params = {"embed": ini.normal((cfg.vocab, d), scale=0.02),
              "pos_dec": ini.normal((cfg.max_seq, d), scale=0.02)}
    for part, n, init in (("enc", cfg.enc_layers, _enc_block_init),
                          ("dec", cfg.dec_layers, _dec_block_init)):
        for name, t in init(ini.stacked(n), cfg).items():
            for i, layer in enumerate(t.unbind(0)):
                params[f"{part}.blocks.{i}.{name}"] = layer
        params.update(_prefixed(f"{part}.ln", _ln_init(ini, d)))
    return params


def init_whisper(cfg: ModelConfig, seed: int,
                 device="cuda") -> dict[str, torch.Tensor]:
    """The reference's initial parameters for `jax.random.key(seed)`
    (`repro.models.whisper.init_whisper`) as the port's state dict, drawn
    in torch on `device`."""
    return _whisper_params(ReferenceInitializer(
        seed, resolve_device(device), cfg.param_dtype), cfg)


def whisper_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """{name: shape} of `init_whisper`'s state dict, drawing nothing."""
    return {k: tuple(v.shape)
            for k, v in _whisper_params(_Shapes(cfg.param_dtype),
                                        cfg).items()}


# logical axes of a whisper block's parameters, by their names in the block
WHISPER_BLOCK_AXES = {
    **{f"{ln}.{k}": ("embed",) for ln in ("ln1", "ln2", "ln3")
       for k in ("w", "b")},
    **{f"{a}.{k}": v for a in ("attn", "self", "cross")
       for k, v in ATTENTION_AXES.items()},
    **_prefixed("mlp", MLP_AXES)}


def whisper_param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """{state-dict name: logical axes} of `init_whisper`'s parameters: the
    reference's axes tree with the stacked "layers" axis dropped, keyed as
    the port's state dict."""
    top = {"embed": ("vocab", "embed"), "pos_dec": (None, "embed")}
    out = {}
    for key in whisper_shapes(cfg):
        part, _, rest = key.partition(".")
        if key in top:
            out[key] = top[key]
        elif rest.startswith("ln."):
            out[key] = ("embed",)
        else:
            out[key] = WHISPER_BLOCK_AXES[rest.split(".", 2)[2]]
    return out


def whisper_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                       enc_len: int | None = None, *, device="cuda") -> dict:
    """Self-attention K/V and the cross K/V of every decoder layer, zero,
    each (dec_layers, B, T, Hkv, hd) in the compute dtype (T = max_len,
    or enc_len for the cross K/V: max_len when not given, as in the
    reference)."""
    enc_len = enc_len or max_len
    dev = resolve_device(device)

    def z(t):
        return torch.zeros((cfg.dec_layers, batch, t, cfg.n_kv_heads,
                            cfg.hd), dtype=cfg.dtype, device=dev)

    return {"k": z(max_len), "v": z(max_len), "xk": z(enc_len),
            "xv": z(enc_len)}


class Whisper(nn.Module):
    """The encoder-decoder with `DecoderLM`'s API: `loss(batch)`,
    `forward(batch)`, `init_cache`, `decode_step`, the weights held by the
    module; `encode`, `decode_train` and `prefill_cross` besides."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.config = cfg
        self.embed = nn.Parameter(params["embed"])
        self.pos_dec = nn.Parameter(params["pos_dec"])
        for part, n in (("enc", cfg.enc_layers), ("dec", cfg.dec_layers)):
            stack = nn.Module()
            stack.blocks = nn.ModuleList([
                ParamTree(_subtree(params, f"{part}.blocks.{i}."))
                for i in range(n)])
            stack.ln = ParamTree(_subtree(params, f"{part}.ln."))
            self.add_module(part, stack)
        self._decode = None             # (parameter versions, weights)

    # ------------------------------------------------------------ training
    def _enc_block(self, tree, x):
        cfg = self.config
        w = tree.weights(x.dtype)
        x = _residual(x, cross_attention(w["attn"], cfg, _ln(x, w["ln1"])))
        return _residual(x, mlp_apply(w["mlp"], _ln(x, w["ln2"]),
                                      cfg.mlp_act))

    def _dec_block(self, tree, x, enc_out):
        cfg = self.config
        w = tree.weights(x.dtype)
        x = _residual(x, attention_apply(w["self"], cfg, _ln(x, w["ln1"]),
                                         rope=False))
        x = _residual(x, cross_attention(w["cross"], cfg, _ln(x, w["ln2"]),
                                         kv_x=enc_out))
        return _residual(x, mlp_apply(w["mlp"], _ln(x, w["ln3"]),
                                      cfg.mlp_act))

    def _remat(self) -> bool:
        return self.config.remat and torch.is_grad_enabled()

    def encode(self, frames):
        """frames (B, S_enc, d_model) stub embeddings -> (B, S_enc, D) in
        the compute dtype."""
        cfg = self.config
        # on a mesh: laid out as the rules say, as the decoder LM's
        # activations are (left as placed, the blocks' adds and norms ask
        # DTensor for shard-to-partial moves)
        x = constrain(frames.to(cfg.dtype), ("batch", "seq", "embed"))
        x = x + replicated_like(sinusoidal_positions(
            x.shape[1], cfg.d_model, x.device), x).to(x.dtype)
        for tree in self.enc.blocks:
            body = functools.partial(self._enc_block, tree)
            x = (checkpoint(body, x, use_reentrant=False) if self._remat()
                 else body(x))
        return _ln(x, self.enc.ln.weights(x.dtype))

    def decode_train(self, tokens, enc_out):
        """tokens (B, S) teacher-forced against enc_out -> final hidden
        states (B, S, D)."""
        cfg = self.config
        # F.embedding: its gradient sums a repeated token's rows in a
        # fixed order (indexing's would scatter-add them)
        # on a mesh: the lookup in a vocab-sharded table is partial
        x = constrain(reduce_partial(F.embedding(
            tokens, self.embed.to(cfg.dtype))), ("batch", "seq", "embed"))
        x = x + self.pos_dec[:tokens.shape[1]].to(x.dtype)[None]
        for tree in self.dec.blocks:
            body = functools.partial(self._dec_block, tree)
            x = (checkpoint(body, x, enc_out, use_reentrant=False)
                 if self._remat() else body(x, enc_out))
        return _ln(x, self.dec.ln.weights(x.dtype))

    def _inputs(self, batch: dict) -> dict:
        dev = self.embed.device
        out = {"tokens": torch.as_tensor(batch["tokens"], device=dev).long(),
               "frames": torch.as_tensor(batch["frames"], device=dev)}
        if "labels" in batch:
            out["labels"] = torch.as_tensor(batch["labels"],
                                            device=dev).long()
        return out

    def hidden(self, tokens, frames):
        """The decoder's final hidden states over the encoded frames."""
        if torch.is_grad_enabled():
            self._decode = None
        return self.decode_train(tokens, self.encode(frames))

    def forward(self, batch: dict):
        """{tokens, frames} -> final hidden states (B, S, D)."""
        b = self._inputs(batch)
        return self.hidden(b["tokens"], b["frames"])

    def loss(self, batch: dict):
        """{tokens (B,S), labels (B,S), frames (B,S_enc,D)} (numpy or
        tensors) -> the mean NLL, chunked over the sequence."""
        b = self._inputs(batch)
        h = self.hidden(b["tokens"], b["frames"])
        return chunked_softmax_xent(h, self.embed, b["labels"],
                                    chunk=self.config.xent_chunk)

    # -------------------------------------------------------------- decode
    def decode_weights(self) -> dict:
        """The weights the decode step reads, in the compute dtype (the
        norms and `pos_dec` in param_dtype, cast at use): cast once and
        kept until a parameter changes in place."""
        versions = tuple((p.to_local() if is_dtensor(p) else p)._version
                         for p in self.parameters())
        if self._decode is None or self._decode[0] != versions:
            self._decode = None
            dt = self.config.dtype
            with torch.no_grad():
                self._decode = (versions, {
                    "embed": self.embed.detach().to(dt),
                    "pos_dec": self.pos_dec.detach(),
                    "blocks": [t.weights(dt) for t in self.dec.blocks],
                    "ln": self.dec.ln.weights(dt)})
        return self._decode[1]

    def init_cache(self, batch: int, max_len: int,
                   enc_len: int | None = None) -> dict:
        return whisper_init_cache(self.config, batch, max_len, enc_len,
                                  device=self.embed.device)

    @torch.no_grad()
    def prefill_cross(self, enc_out, cache: dict) -> dict:
        """Fill the cross K/V of every decoder layer from the encoder's
        output (B, S_enc, D): `cache["xk"]` / `["xv"]` become
        (dec_layers, B, S_enc, Hkv, hd) in enc_out's dtype.  Returns the
        cache."""
        cfg = self.config
        b, s, _ = enc_out.shape
        shape = (b, s, cfg.n_kv_heads, cfg.hd)
        xk, xv = [], []
        for tree in self.dec.blocks:
            xk.append((enc_out @ tree.cross.wk.to(enc_out.dtype))
                      .reshape(shape))
            xv.append((enc_out @ tree.cross.wv.to(enc_out.dtype))
                      .reshape(shape))
        cache["xk"], cache["xv"] = torch.stack(xk), torch.stack(xv)
        return cache

    @torch.no_grad()
    def decode_step(self, token, cache: dict, index: int):
        """token (B, 1) int at position `index` against the cache (updated
        in place) -> logits (B, V) float32.  On a mesh (DTensor weights
        and cache) the token ids go whole and each attention runs through
        `decode_on_shards`."""
        cfg = self.config
        wts = self.decode_weights()
        b = token.shape[0]
        hd, hkv, hq = cfg.hd, cfg.n_kv_heads, cfg.n_heads
        kc = cfg.attn_k_chunk
        emb = wts["embed"]
        if is_dtensor(token):
            token = token.redistribute(token.device_mesh,
                                       replicated(token))
        x = reduce_partial(F.embedding(token, emb))         # (B, 1, D)
        x = x + wts["pos_dec"][index].to(x.dtype)
        for i, w in enumerate(wts["blocks"]):
            h = _ln(x, w["ln1"])
            q = matmul(h, w["self"]["wq"]).reshape(b, 1, hq, hd)
            k = matmul(h, w["self"]["wk"]).reshape(b, 1, hkv, hd)
            v = matmul(h, w["self"]["wv"]).reshape(b, 1, hkv, hd)
            a = _decode_attend(q, k, v, cache["k"][i], cache["v"][i], index,
                               index + 1, kc)
            x = x + matmul(a.reshape(b, 1, hq * hd), w["self"]["wo"])
            # cross-attention against the precomputed encoder K/V
            h = _ln(x, w["ln2"])
            q = matmul(h, w["cross"]["wq"]).reshape(b, 1, hq, hd)
            xk = cache["xk"][i]
            a = _decode_attend(q, None, None, xk, cache["xv"][i], 0,
                               xk.shape[1], kc)
            x = x + matmul(a.reshape(b, 1, hq * hd), w["cross"]["wo"])
            x = x + mlp_apply(w["mlp"], _ln(x, w["ln3"]), cfg.mlp_act)
        x = _ln(x, wts["ln"])
        return logits_last(x[:, 0], emb)


def _residual(x, y):
    """x + y, a block's output y (on a mesh: partial over the ranks that
    split its heads or its hidden units) reduced to x's placements first
    by an explicit reduce-scatter or all-reduce (`reduce_to`), not by
    DTensor, which may move x's sequence shard into a partial sum."""
    return x + (reduce_to(y, x.placements) if is_dtensor(x) else y)


def _decode_attend(q, k, v, kc, vc, index: int, length: int, k_chunk: int):
    """q (B,1,Hq,hd) against one layer's cache kc/vc (B,T,Hkv,hd) with
    `length` valid positions, the new row k/v (B,1,Hkv,hd) written at
    `index` first (None: no write, the cross K/V) -> (B,1,Hq,hd).  A
    DTensor cache goes through `decode_on_shards`."""
    if is_dtensor(kc):
        return decode_on_shards(q, k, v, {"k": kc, "v": vc}, index, k_chunk,
                                length=length)
    if k is not None:
        kc[:, index:index + 1] = k
        vc[:, index:index + 1] = v
    return chunked_decode_attention(q[:, 0], kc, vc, length=length,
                                    k_chunk=k_chunk)[:, None]


def encode(model: Whisper, frames):
    """Functional alias of `Whisper.encode`."""
    return model.encode(frames)


def decode_train(model: Whisper, tokens, enc_out):
    """Functional alias of `Whisper.decode_train`."""
    return model.decode_train(tokens, enc_out)


def whisper_loss(model: Whisper, batch: dict):
    """Functional alias of `Whisper.loss`."""
    return model.loss(batch)


def whisper_prefill_cross(model: Whisper, enc_out, cache: dict) -> dict:
    """Functional alias of `Whisper.prefill_cross`."""
    return model.prefill_cross(enc_out, cache)


def whisper_decode_step(model: Whisper, token, cache: dict, index: int):
    """Functional alias of `Whisper.decode_step`."""
    return model.decode_step(token, cache, index)
