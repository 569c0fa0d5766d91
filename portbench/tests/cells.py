"""Small cells for the CPU tests: the decode and kv_tier drivers at smoke
size, run through the harness with the plain versions of the kernels."""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

MODEL = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 128,
         "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 256,
         "vocab": 512, "mlp_act": "swiglu", "qk_norm": False,
         "rope_theta": 10000.0, "tie_embeddings": True,
         "dtype": "bfloat16", "param_dtype": "bfloat16",
         "attn_q_chunk": 64, "attn_k_chunk": 64}
# deep and wide enough that bf16 flips routing choices, as at full size
MOE = dict(MODEL, name="tiny-moe", family="moe", n_layers=4, d_model=256,
           n_heads=8, n_experts=32, top_k=4, moe_every=1,
           capacity_factor=1.25, d_ff=64)
DECODE = {"driver": "decode", "chips": 1,
          "traffic": {"batch": 8, "prefix": 40, "tokens": 12,
                      "cache_len": 64, "trace_steps": 3}}
KV = {"driver": "kv_tier", "chips": 1,
      "traffic": {"slots": 4, "page": 16, "policy": "dynamic",
                  "packing": "pair", "prompt_min": 64, "prompt_max": 160,
                  "decode_tokens": 32, "compressible_share": 0.75,
                  "scale": 0.002, "chunk": 64, "check_every": 4,
                  "trace_steps": 4}}
BENCH = {"end_to_end": [{"name": "decode_tokens_per_s", "unit": "tokens/s"},
                        {"name": "setup_s", "unit": "s"}],
         "per_layer": []}


def run(kind: str, *, seed: int = 2147483659, seconds: float = 0.5,
        limits: dict, dtype: str = "bfloat16", control: bool = False,
        trace: bool = False, **traffic) -> dict:
    """One CPU run of a small cell: kind "dense", "moe" or "kv"."""
    model = dict(MOE if kind == "moe" else MODEL, dtype=dtype,
                 param_dtype=dtype)
    cell = dict(KV if kind == "kv" else DECODE, name="small",
                config="small", limits=limits)
    cell["traffic"] = dict(cell["traffic"], **traffic)
    if kind == "moe":
        cell["traffic"]["batch"] = traffic.get("batch", 32)
    return harness.run_cell("small", seed, seconds, trace, device="cpu",
                            cell=cell, config={"model": model},
                            bench=BENCH, control=control)
