"""A1: the model's decode attention against its own KV cache, as one GQA
split-KV ("flash-decoding") kernel.

`decode_attention_state` and `chunked_decode_attention`
(`models/attention.py`) attend one query token a sequence against the
cache (B, T, Hkv, D) with `length` valid positions.  On CUDA tensors they
launch `gqa_decode_cuda`, whose kernel is `csrc/gqa_decode.cu`: a CTA per
(sequence, KV head, chunk of at most 8 of its query heads, split of
positions) reads each valid K/V row once for all the query heads it
serves and nothing past `length`; a second launch merges the splits (none
with one split).  Elsewhere (CPU tensors, and tensors with no storage: a
dry run's FakeTensors, meta tensors) they run their plain version, the
chunk loop of `models/attention.py:_q_chunk_state`.  It replaces no TPU
kernel: the reference's decode attention is plain jnp.

The kernel takes K/V in bf16, fp16 or float32 (the same type), q in any
of these, any whole GQA group, a head_dim that is a multiple of 8 from 8
to 256, any B and T, and a Python int `length` (clamped to [0, T]: no
valid position gives m = -1e30, l = 0, o = 0, a state of weight 0 where
ranks combine theirs, and a zero output).  The split width depends on the
shapes alone (`split_geometry`), never on `length`.
"""

from __future__ import annotations

import torch

from . import cuda_lib

# the query heads one CTA serves (a KV head's group is cut into chunks)
MAX_GROUP = 8
# the most splits of one (sequence, KV head) row, the merge's limit
MAX_SPLITS = 64
# split widths are whole multiples of this many positions
SPLIT_QUANTUM = 64
# CTAs a launch aims for: about four waves of 132 SMs at 8 CTAs each
TARGET_CTAS = 4 * 132 * 8

# kernel launches; only the CUDA path counts
LAUNCHES = {"gqa_decode": 0}

_TYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def split_geometry(b: int, hkv: int, hq: int, t: int) -> tuple[int, int]:
    """(width, splits) of a cache of T positions: the fewest splits of
    whole SPLIT_QUANTUM-position runs that give the launch about
    TARGET_CTAS CTAs over B x Hkv x head chunks, at most MAX_SPLITS; the
    last split may be shorter."""
    rows = b * hkv * -(-(hq // hkv) // MAX_GROUP)
    want = min(-(-TARGET_CTAS // rows), MAX_SPLITS,
               -(-t // SPLIT_QUANTUM))
    width = -(-t // max(want, 1))
    width = -(-width // SPLIT_QUANTUM) * SPLIT_QUANTUM
    return width, -(-t // width)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def gqa_decode_cuda(q, k_cache, v_cache, length, *, state: bool):
    """The CUDA kernel: with `state` the (m, l, o) float32 of the plain
    version, else the normalised output (B, Hq, D) in q's dtype."""
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _require(x.device.type == "cuda",
                 f"{name} must be a CUDA tensor, got {x.device}")
        _require(x.device == q.device,
                 f"{name} is on {x.device}, q on {q.device}")
        _require(x.dtype in _TYPES, f"{name} must be bfloat16, float16 or "
                 f"float32, got {x.dtype}")
    _require(isinstance(length, int) and not isinstance(length, bool),
             f"length must be a Python int, got {type(length).__name__}")
    _require(q.dim() == 3 and k_cache.dim() == 4,
             "q must be (B, Hq, D) and the cache (B, T, Hkv, D)")
    b, hq, d = q.shape
    _require(tuple(k_cache.shape) == tuple(v_cache.shape),
             "k_cache and v_cache differ in shape")
    _require(k_cache.dtype == v_cache.dtype,
             "k_cache and v_cache differ in dtype")
    _require(k_cache.shape[0] == b and k_cache.shape[3] == d,
             f"cache {tuple(k_cache.shape)} does not match q "
             f"{tuple(q.shape)}")
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    _require(b > 0 and t > 0, "B and T must be positive")
    _require(hkv > 0 and hq % hkv == 0,
             f"Hq={hq} is not a whole number of groups of Hkv={hkv}")
    _require(d % 8 == 0 and 8 <= d <= 256,
             f"head_dim {d}: the kernel takes a multiple of 8 from 8 to 256")
    _require(k_cache.is_contiguous() and v_cache.is_contiguous(),
             "the cache must be contiguous")
    _require(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
             "the cache must be 16-byte aligned")
    _require(q.stride(2) == 1, "q's head_dim must be contiguous")
    width, splits = split_geometry(b, hkv, hq, t)
    dev, f32 = q.device, torch.float32
    parts = ((torch.empty((b, hq, splits), dtype=f32, device=dev),
              torch.empty((b, hq, splits), dtype=f32, device=dev),
              torch.empty((b, hq, splits, d), dtype=f32, device=dev))
             if splits > 1 else (None, None, None))
    if state:
        m = torch.empty((b, hq), dtype=f32, device=dev)
        l = torch.empty((b, hq), dtype=f32, device=dev)
        o = torch.empty((b, hq, d), dtype=f32, device=dev)
    else:
        m = l = None
        o = torch.empty((b, hq, d), dtype=q.dtype, device=dev)

    def p(x):
        return None if x is None else cuda_lib.ptr(x)

    code = cuda_lib.load().cram_gqa_decode(
        p(q), p(k_cache), p(v_cache), q.stride(0), q.stride(1), b, t, hkv,
        hq, d, _TYPES[k_cache.dtype], _TYPES[q.dtype],
        max(0, min(length, t)), width, splits, int(state), *map(p, parts),
        p(m), p(l), p(o), cuda_lib.stream_ptr(q))
    cuda_lib.check(code, "cram_gqa_decode")
    LAUNCHES["gqa_decode"] += 1
    # q.k and p.v over the valid positions only; the plain version's two
    # products cover every position of its whole chunks, masked, so a dry
    # run on fake tensors counts all of T and the two agree where
    # length == T
    cuda_lib.count_flops(4.0 * b * max(0, min(length, t)) * hq * d)
    return (m, l, o) if state else o
