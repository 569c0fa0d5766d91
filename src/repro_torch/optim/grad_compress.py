"""Compressed gradient collectives for data parallelism (port of
`repro.optim.grad_compress`: the paper's §VI applied to DP).

int8 per-tensor quantization with error feedback around an explicit
all-reduce over the mesh's "data" group (`torch.distributed`, one process
a rank).  The Dynamic-CRAM saturating counter (`compression.gate`) gates
the mechanism at run time: benefit = bytes saved on the wire, cost = a
quality signal (the relative quantization error over its budget).

Where the reference computes the quantized and the plain tree and picks
one with `jnp.where`, the step here reads the gate once on the host and
computes, sends and applies the chosen leaf only, one leaf at a time, so
that at full width it holds three trees (parameters, gradients, error
feedback) and one leaf's temporaries.  The reference's `shard_map` runs
with `check_rep=False`, so what it returns for the replicated counter is
shard 0's; here every rank updates the counter from rank 0's relative
error, so the counter, and with it the gate, is the same on every rank,
and each rank keeps its own error feedback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bandwidth.adapters import (
    grad_wire_event,
    int8_wire_bytes,
    tree_wire_bytes,
)
from ..compression.gate import (  # noqa: F401  (COUNTER_MAX re-exported)
    COUNTER_MAX,
    ENABLE_THRESHOLD,
    counter_step,
    wire_counter_step,
)

ENABLE = ENABLE_THRESHOLD  # legacy alias
POLICIES = ("dynamic", "static", "off", "auto")


def quantize_int8(g):
    """Per-tensor symmetric int8: (codes, float32 scale), scale =
    max|g| / 127 (at least 1e-12 / 127), codes rounded half to even (one
    temporary of g's size, rounded and clamped in place)."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.div(g, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32, copy=True).mul_(scale)


def _compress_leaf(g, e):
    """(dequantized g + e in g's dtype, its float32 value, g + e in
    float32)."""
    g32 = g.to(torch.float32) + e
    dq32 = dequantize(*quantize_int8(g32))
    return dq32.to(g.dtype), dq32, g32


def _sq_err(dq, g):
    """(sum of (dq - g)^2, sum of g^2) in float32."""
    g32 = g.to(torch.float32)
    return (torch.sub(dq.to(torch.float32), g32).square_().sum(),
            torch.square(g32).sum())


def _rel(num, den):
    return torch.sqrt(num / torch.clamp(den, min=1e-30))


def compress_tree(grads: dict, err: dict):
    """Error-feedback int8 compression of a gradient dict.  Returns
    (dequantized grads, new error feedback, rel_err scalar)."""
    dq, new_err = {}, {}
    num = den = 0.0
    for k, g in grads.items():
        dq[k], dq32, g32 = _compress_leaf(g, err[k])
        new_err[k] = g32 - dq32
        n, d = _sq_err(dq[k], g)
        num, den = num + n, den + d
    return dq, new_err, _rel(torch.as_tensor(num), torch.as_tensor(den))


def gate_update(counter, rel_err, *, err_budget: float = 0.05,
                bytes_saving: float = 0.75):
    """Saturating-counter gate: wire-bytes saved vs quality cost (the
    scaling constants live in compression.gate); `bytes_saving` is the
    measured fractional wire-byte win.  Tensors in, an int32 tensor out;
    numpy in, numpy out."""
    if isinstance(counter, torch.Tensor) or isinstance(rel_err,
                                                        torch.Tensor):
        counter = torch.as_tensor(counter, dtype=torch.int32)
        over = torch.as_tensor(rel_err).to(counter.device) > err_budget
        return wire_counter_step(counter, bytes_saving, over,
                                 torch).to(torch.int32)
    return wire_counter_step(counter, bytes_saving,
                             np.asarray(rel_err) > err_budget, np)


def gate_enabled(counter):
    return counter >= ENABLE_THRESHOLD


def make_dp_compressed_step(model, mesh, *, lr=1e-3,
                            policy: str = "dynamic", ledger=None):
    """Explicit-collective DP train step with gated int8 grad compression,
    over the "data" group of `mesh` (a DeviceMesh; this process is one of
    its ranks and holds the full parameters).

    Returns step(params, err, counter, batch) -> (params, err, counter,
    loss), whose attribute `last` holds the last call's gate decision
    ("enabled") and relative quantization error ("rel_err", a 0-d tensor;
    None under "off", which quantizes nothing): `params` must be `model`'s parameters (a dict keyed as its
    state dict), updated in place; `err` the error feedback, float32
    tensors keyed alike, updated in place; `counter` a 0-d int32 tensor,
    returned anew; `batch` the global batch (a dict of arrays or one
    array), of which this rank takes rows [r * B / n, (r + 1) * B / n)
    for its index r in the group.  The
    rank's gradients (autograd on `model.loss`) go through error-feedback
    int8 compression when the gate is on, then `all_reduce(SUM) / n` (the
    reference's `pmean`), then the SGD update p - lr * g in float32.

    policy: "dynamic" (the §VI gate; "auto" is an alias), "static"
    (always quantize), "off" (plain collectives).  A bandwidth `ledger`
    books each step's wire bytes (raw vs what the gate sent, by the
    counter that entered the step) under consumer "grad"."""
    import torch.distributed as dist

    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    dynamic = policy in ("dynamic", "auto")
    group = mesh.get_group("data")
    n = dist.get_world_size(group)
    index = dist.get_rank(group)
    root = dist.get_global_rank(group, 0)
    own = dict(model.named_parameters())

    def step(params, err, counter, batch):
        if params.keys() != own.keys() or any(
                params[k] is not p for k, p in own.items()):
            raise ValueError("params are not this model's parameters")
        # the counter entering the step gates it: one read on the host
        enabled = (policy == "static"
                   or (dynamic and int(counter) >= ENABLE_THRESHOLD))
        rows = len(next(iter(batch.values())) if isinstance(batch, dict)
                   else batch)
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} data ranks")
        mine = slice(index * rows // n, (index + 1) * rows // n)
        part = ({k: v[mine] for k, v in batch.items()}
                if isinstance(batch, dict) else batch[mine])
        for p in own.values():
            p.grad = None
        loss = model.loss(part)
        loss.backward()
        loss = loss.detach()
        num = den = None
        with torch.no_grad():
            for k, p in own.items():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                send = g
                if enabled or dynamic:
                    dq, dq32, g32 = _compress_leaf(g, err[k])
                    sq = _sq_err(dq, g)
                    num = sq[0] if num is None else num + sq[0]
                    den = sq[1] if den is None else den + sq[1]
                    if enabled:
                        torch.sub(g32, dq32, out=err[k])
                        send = dq
                    del dq32, g32
                if not enabled:
                    err[k].zero_()
                dist.all_reduce(send, group=group)
                send.div_(n)
                p.copy_(p.to(torch.float32) - lr * send.to(torch.float32))
                p.grad = None
                del send, g
            if dynamic:
                rel = _rel(num, den)
                dist.broadcast(rel, src=root, group=group)
                saving = 1.0 - int8_wire_bytes(own) / tree_wire_bytes(own)
                counter = gate_update(counter, rel, bytes_saving=saving)
            dist.all_reduce(loss, group=group)
            loss.div_(n)
        step.last = {"enabled": enabled,
                     "rel_err": None if num is None else _rel(num, den)}
        if ledger is not None:
            grad_wire_event(ledger, own, enabled=enabled)
        return params, err, counter, loss

    step.last = {"enabled": None, "rel_err": None}
    return step


__all__ = ["quantize_int8", "dequantize", "compress_tree", "gate_update",
           "gate_enabled", "make_dp_compressed_step", "ENABLE",
           "ENABLE_THRESHOLD", "COUNTER_MAX"]
