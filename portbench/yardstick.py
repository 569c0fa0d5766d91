"""The benchmark's yardstick: the chip's peaks, seeds, the seeded inputs
(weights, KV streams) and the operation and byte counts the per-layer
metrics divide by.  It imports torch and numpy only: neither the program
(`repro_torch`) nor JAX, so a change to the program cannot move it.

A model configuration reaches these functions as the plain dict under
"model" in `portbench/configs/<config>.json` (the port's `ModelConfig`
field names)."""

from __future__ import annotations

import math

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


# ------------------------------------------------------------------ seeds

def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the input named by `keys` (ints or strings) under
    the run's `seed`: independent streams for independent inputs, the same
    stream for the same name."""
    words = [seed % (1 << 64)]
    for k in keys:
        if isinstance(k, str):
            words.extend(k.encode())
        else:
            words.append(int(k) % (1 << 64))
    st = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(st[0]) << 31) ^ int(st[1])


def generator(device, seed: int, *keys) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *keys))
    return g


def permutation(seed: int, n: int, *keys) -> np.ndarray:
    return np.random.default_rng(sub_seed(seed, *keys)).permutation(n)


# ------------------------------------------------------------- statistics

def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


# ------------------------------------------------------- model geometry

def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_kinds(cfg: dict) -> list[str]:
    """The kind of each layer: the dense and moe families of `DecoderLM`
    (a MoE MLP every `moe_every`-th layer)."""
    if cfg["family"] == "dense":
        return ["dense"] * cfg["n_layers"]
    if cfg["family"] == "moe":
        k = max(cfg.get("moe_every", 1), 1)
        return [("moe" if (i + 1) % k == 0 else "dense")
                for i in range(cfg["n_layers"])]
    raise ValueError(f"no yardstick for family {cfg['family']!r}")


def layer_shapes(cfg: dict, kind: str) -> dict[str, tuple]:
    """One layer's matrices {name: shape}, named as the port's state
    dict names them inside `blocks.{i}.`."""
    d, hd = cfg["d_model"], head_dim(cfg)
    hq, hkv, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    out = {"attn.wq": (d, hq * hd), "attn.wk": (d, hkv * hd),
           "attn.wv": (d, hkv * hd), "attn.wo": (hq * hd, d)}
    swiglu = cfg.get("mlp_act", "swiglu") == "swiglu"
    if kind == "moe":
        e = cfg["n_experts"]
        out.update({"moe.router": (d, e), "moe.w1": (e, d, f),
                    "moe.w2": (e, f, d)})
        if swiglu:
            out["moe.w3"] = (e, d, f)
    else:
        out.update({"mlp.w1": (d, f), "mlp.w2": (f, d)})
        if swiglu:
            out["mlp.w3"] = (d, f)
    return out


def _scale(name: str, shape: tuple) -> float:
    """The port's init scales: normal / sqrt(fan_in), the router at
    0.02."""
    if name.endswith("router"):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded random weights in the served dtype (`param_dtype`), made on
    `device` in one draw a layer (and one for the embedding), keyed by
    the port's state-dict names.  The norms are ones."""
    dt = DTYPES[cfg["param_dtype"]]
    d = cfg["d_model"]
    g = generator(device, seed, "weights")
    out = {"embed": torch.randn((cfg["vocab"], d), generator=g,
                                device=device, dtype=dt).mul_(0.02),
           "final_ln": torch.ones((d,), dtype=dt, device=device)}
    hd = head_dim(cfg)
    for i, kind in enumerate(layer_kinds(cfg)):
        shapes = layer_shapes(cfg, kind)
        flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                           generator=g, device=device, dtype=dt)
        at = 0
        pre = f"blocks.{i}."
        out[pre + "ln1"] = torch.ones((d,), dtype=dt, device=device)
        out[pre + "ln2"] = torch.ones((d,), dtype=dt, device=device)
        if cfg.get("qk_norm"):
            out[pre + "attn.q_norm"] = torch.ones((hd,), dtype=dt,
                                                  device=device)
            out[pre + "attn.k_norm"] = torch.ones((hd,), dtype=dt,
                                                  device=device)
        for name, shape in shapes.items():
            n = math.prod(shape)
            out[pre + name] = flat[at:at + n].view(shape).mul_(
                _scale(name, shape))
            at += n
    return out


# ----------------------------------------------------------- the counts

def expected_experts(cfg: dict, tokens: int) -> float:
    """Distinct experts a step's `tokens` route to, in expectation under
    uniform routing: E (1 - (1 - k/E)^T)."""
    e, k = cfg["n_experts"], cfg["top_k"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def matmul_params(cfg: dict, *, experts: float | None = None) -> dict:
    """Weights of the step's matrix products: {"per_token": parameters
    each token multiplies by (attention, the dense MLPs, the router and
    its top-k experts, the tied output head), "read": parameters a step
    reads, with `experts` distinct experts of each MoE layer}."""
    per_token = read = 0.0
    for kind in layer_kinds(cfg):
        for name, shape in layer_shapes(cfg, kind).items():
            n = math.prod(shape)
            if name in ("moe.w1", "moe.w2", "moe.w3"):
                e = cfg["n_experts"]
                per_token += n / e * cfg["top_k"]
                read += n / e * (e if experts is None else experts)
            else:
                per_token += n
                read += n
    head = cfg["vocab"] * cfg["d_model"]
    return {"per_token": per_token + head, "read": read + head}


def attention_flops(contexts, n_heads: int, hd: int, layers: int) -> float:
    """4 x context x Hq x hd a token a layer: q.k and p.v over each
    attended position."""
    return 4.0 * float(sum(contexts)) * n_heads * hd * layers


def decode_step_flops(cfg: dict, contexts) -> float:
    """Model FLOPs of one decode step of len(contexts) sequences, each
    attending `contexts[i]` positions: 2 x the parameters a token uses x
    the tokens, plus attention's."""
    p = matmul_params(cfg)["per_token"]
    return (2.0 * p * len(contexts)
            + attention_flops(contexts, cfg["n_heads"], head_dim(cfg),
                              cfg["n_layers"]))


def decode_step_min_bytes(cfg: dict, contexts) -> float:
    """Least bytes one decode step moves: each weight it uses read once in
    the served dtype (every expert a token routes to, in expectation),
    the KV of every attended position read once and the new rows written
    once (compute dtype), the token embeddings read and the float32
    logits written."""
    wb = DTYPES[cfg["param_dtype"]].itemsize
    ab = DTYPES[cfg["dtype"]].itemsize
    b = len(contexts)
    experts = (expected_experts(cfg, b) if cfg["family"] == "moe"
               else None)
    weights = matmul_params(cfg, experts=experts)["read"] * wb
    row = 2 * cfg["n_kv_heads"] * head_dim(cfg) * ab * cfg["n_layers"]
    kv = row * float(sum(contexts))     # b - 1 rows read, the new row written
    return weights + kv + b * cfg["d_model"] * wb + b * cfg["vocab"] * 4


# ------------------------------------------------------------ KV stream

def kv_chunk(device, seed: int, session: int, chunk: int, tokens: int,
             n_kv: int, hd: int, *, compressible: bool,
             scale: float = 2e-3):
    """Tokens [chunk * tokens, (chunk + 1) * tokens) of one session's KV
    stream, (tokens, n_kv, hd) bf16 K and V made on `device`: a device
    copy of the port's `synthetic_kv_stream`.  Compressible sessions
    hover multiplicatively (`scale`) around a per-session base of
    2 + 0.2 N(0, 1), so bf16 pages delta-pack against their group's
    base row; incompressible ones are unit normals."""
    g = generator(device, seed, "kv", session, chunk)
    shape = (tokens, n_kv, hd)
    if compressible:
        gb = generator(device, seed, "kv-base", session)
        base = 2.0 + torch.randn((1, n_kv, hd), generator=gb,
                                 device=device) * 0.2
        k = base * (1 + torch.randn(shape, generator=g, device=device)
                    * scale)
        v = base * (1 + torch.randn(shape, generator=g, device=device)
                    * scale)
    else:
        k = torch.randn(shape, generator=g, device=device)
        v = torch.randn(shape, generator=g, device=device)
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def kv_tokens(device, seed: int, session: int, start: int, stop: int,
              n_kv: int, hd: int, *, chunk: int, compressible: bool,
              scale: float = 2e-3):
    """Tokens [start, stop) of a session's stream, from its chunks."""
    ks, vs = [], []
    for c in range(start // chunk, -(-stop // chunk)):
        k, v = kv_chunk(device, seed, session, c, chunk, n_kv, hd,
                        compressible=compressible, scale=scale)
        lo = max(start - c * chunk, 0)
        hi = min(stop - c * chunk, chunk)
        ks.append(k[lo:hi])
        vs.append(v[lo:hi])
    return torch.cat(ks), torch.cat(vs)


# ------------------------------------------------------- CRAM-KV layout

def slot_bytes(page: int, n_kv: int, hd: int) -> tuple[int, int]:
    """(slot, strip) bytes of the CRAM-KV layout: a slot is one page of
    bf16 K||V rows, its strip a base row of K||V plus a 4-byte marker."""
    return page * n_kv * 2 * hd * 2, n_kv * (2 * hd + 2) * 2


def k3_bytes(layout_bytes: float, sessions: int, n_heads: int,
             hd: int) -> float:
    """Least bytes one batched K3 call moves: the layout's slots and
    strips of every live group (`layout_bytes`, the reference's count)
    and one float32 query row in and one out a session."""
    return layout_bytes + 2.0 * sessions * n_heads * hd * 4
