"""AdamW with global-norm clipping, the cosine schedule and the train step
(port of `repro.optim.adamw`).

The update keeps the reference's arithmetic: the clip scale is
min(1, clip / max(gnorm, 1e-9)), the bias corrections use a float32 step,
eps is added after sqrt(vhat), weight decay sits inside the step, and the
update runs in float32 with the moments stored in `optimizer_dtype`.
Unlike the reference (whose arrays are immutable), the update writes
the parameters and moments in place, a slice of `_CHUNK` elements at a
time, so its temporaries stay small beside a multi-GB tensor.
`torch.optim.AdamW` orders the same operations differently and is not
used.

The state may be placed on a mesh (`launch.steps.place_cell`): every
tensor a DTensor.  Each leaf's update then runs on its moments' local
shards (ZeRO-1): the gradient is redistributed to the moments'
placements (a reduce-scatter where it is partial), and a parameter
placed otherwise (`fsdp=False`) is updated on the same shard and
gathered back into its own placements.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..runtime.sharding import batch_rows, is_dtensor, reduce_partial

# elements of one parameter updated at a time
_CHUNK = 1 << 24
# dyn_counter's start: the Dynamic-CRAM gate for gradient compression
DYN_COUNTER_INIT = 2048 + 128


@dataclass
class TrainState:
    """params: the model's parameters (the same tensors, keyed by their
    state-dict names); m, v: the moments, keyed alike; step and
    dyn_counter: 0-d int32 tensors.  `per` is the number of layers in a
    super-block, by which a checkpoint stacks the port's layers into the
    reference's `blocks/b{j}` leaves."""
    params: dict
    m: dict
    v: dict
    step: torch.Tensor
    dyn_counter: torch.Tensor  # Dynamic-CRAM-style gate for grad compression
    per: int = 1


def abstract_opt_state(params: dict, moment_dtype=torch.float32
                       ) -> TrainState:
    """The train state of `params` (a dict of meta tensors, as
    `models.abstract_params` gives) as meta tensors: the moments in
    `moment_dtype`, step and dyn_counter 0-d int32.  Allocates nothing."""
    def like(p):
        return torch.empty(p.shape, dtype=moment_dtype, device="meta")

    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params=params,
                      m={k: like(p) for k, p in params.items()},
                      v={k: like(p) for k, p in params.items()},
                      step=scalar, dyn_counter=scalar.clone())


def adamw_init(params, moment_dtype=torch.float32) -> TrainState:
    """`params`: a `DecoderLM` (its parameters and layout) or a dict of
    tensors.  Moments start at zero in `moment_dtype`."""
    per = getattr(params, "per", 1)
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    dev = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
                for k, p in params.items()}

    return TrainState(
        params=params, m=zeros(), v=zeros(),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        dyn_counter=torch.tensor(DYN_COUNTER_INIT, dtype=torch.int32,
                                 device=dev),
        per=per)


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for lo in range(0, flat.numel(), _CHUNK):
        yield flat[lo:lo + _CHUNK]


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 sum of squares; a DTensor's (its pending sums
    reduced first) summed over the ranks that hold its shards, a plain
    tensor on every rank."""
    if not is_dtensor(x):
        return sum(torch.dot(c.to(torch.float32), c.to(torch.float32))
                   for c in _chunks(x))
    local = _sumsq(reduce_partial(x).to_local().contiguous())
    part = [Partial() if isinstance(p, Shard) else Replicate()
            for p in x.placements]
    return DTensor.from_local(local, x.device_mesh, part).full_tensor()


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = 0
    for x in tree.values():
        total = total + _sumsq(x)
    return torch.sqrt(total)


def _plain(x):
    """A DTensor's full value on this rank; a tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _shards(p, g, m, v):
    """The local tensors of one leaf's update, and a function that writes
    the updated parameter shard back.  Plain tensors: themselves.  A
    DTensor leaf: each at the moments' placements (the gradient
    redistributed there, the parameter's shard of a differently placed
    parameter copied out), so the update is elementwise on local
    shards."""
    if not is_dtensor(m):
        return p, g, m, v, None
    mesh, pl = m.device_mesh, m.placements
    gl = g.redistribute(mesh, pl).to_local().contiguous()
    if p.placements == pl:
        return p.to_local(), gl, m.to_local(), v.to_local(), None
    pl_ = p.redistribute(mesh, pl).to_local().contiguous().clone()

    def write_back():
        full = DTensor.from_local(pl_, mesh, pl).redistribute(
            mesh, p.placements)
        p.to_local().copy_(full.to_local())

    return pl_, gl, m.to_local(), v.to_local(), write_back


def _update(state: TrainState, grads: dict, gnorm, *, lr, b1, b2, eps,
            weight_decay, clip_norm) -> TrainState:
    f32 = torch.float32
    step = _plain(state.step) + 1
    stepf = step.to(f32)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=stepf.device),
                        stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=stepf.device),
                        stepf)
    lr = _plain(lr)
    with torch.no_grad():
        for k, p in state.params.items():
            pl, gl, ml, vl, write_back = _shards(p, grads[k], state.m[k],
                                                 state.v[k])
            for pc, gc, mc, vc in zip(*(_chunks(t) for t in (
                    pl, gl, ml, vl))):
                g = gc.to(f32) * scale
                m32 = mc.to(f32) * b1 + g * (1 - b1)
                v32 = vc.to(f32) * b2 + torch.square(g) * (1 - b2)
                mhat = m32 / bc1
                vhat = v32 / bc2
                p32 = pc.to(f32)
                delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
                pc.copy_(p32 - lr * delta)
                mc.copy_(m32)
                vc.copy_(v32)
            if write_back is not None:
                write_back()
    if is_dtensor(state.step):
        step = DTensor.from_local(step, state.step.device_mesh,
                                  state.step.placements)
    state.step = step
    return state


def adamw_update(state: TrainState, grads: dict, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0) -> TrainState:
    """One AdamW step with `grads` (keyed like `state.params`), written
    into the state's tensors in place; returns the state."""
    return _update(state, grads, global_norm(grads), lr=lr, b1=b1, b2=b2,
                   eps=eps, weight_decay=weight_decay, clip_norm=clip_norm)


def cosine_lr(step: torch.Tensor, *, peak=3e-4, warmup=100, total=10_000,
              floor=3e-5) -> torch.Tensor:
    """Linear warm-up to `peak`, then a cosine down to `floor` at
    `total`; float32, as the reference computes it."""
    step = step.to(torch.float32)
    warm = peak * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (
        1 + torch.cos(float(torch.tensor(math.pi, dtype=torch.float32)) * t))
    return torch.where(step < warmup, warm, cos)


def make_train_step(model, *, lr_peak=3e-4, lr_total=10_000,
                    grad_compress=None, microbatches=None):
    """Returns train_step(state, batch) -> (state, metrics) for `model` (a
    `DecoderLM`), whose parameters must be `state.params`.

    The batch (numpy arrays or tensors, moved to the model's device by
    the model) is split into `mb` microbatches of consecutive rows, mb =
    `microbatches` or `cfg.microbatches` lowered until it divides the
    batch, as in the reference (on a mesh, each rank's rows of a
    microbatch come by an all-to-all, `batch_rows`, not by a gather of
    the batch); each microbatch's backward accumulates into the `.grad` of
    the parameters (float32 where `param_dtype` is; no second accumulator
    as large as the parameters), which is then divided by mb.
    `grad_compress`: an optional callable grads -> grads.  The model's
    parameters are read at each call, so a model placed on a mesh after
    this is made (`launch.steps.place_cell`) trains as placed; the loss
    and gnorm come back as plain tensors."""
    cfg = model.config

    def train_step(state: TrainState, batch: dict):
        own = dict(model.named_parameters())
        if state.params.keys() != own.keys() or any(
                state.params[k] is not p for k, p in own.items()):
            raise ValueError("state.params are not this model's parameters")
        b = len(batch["tokens"])
        mb = microbatches or cfg.microbatches
        while b % mb:
            mb -= 1
        for p in own.values():
            p.grad = None
        size = b // mb
        lsum = None
        for i in range(mb):
            part = {k: batch_rows(v, i * size, (i + 1) * size)
                    for k, v in batch.items()}
            loss = model.loss(part)
            loss.backward()
            loss = _plain(loss.detach())
            lsum = loss if lsum is None else lsum + loss
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in own.items()}
        if is_dtensor(state.m[next(iter(own))]):
            # ZeRO-1: each gradient reduce-scattered to its moments' shards
            grads = {k: g.redistribute(state.m[k].device_mesh,
                                       state.m[k].placements)
                     for k, g in grads.items()}
        if mb > 1:
            loss = lsum / mb
            for g in grads.values():
                g.div_(mb)
        if grad_compress is not None:
            grads = grad_compress(grads)
        lr = cosine_lr(_plain(state.step), peak=lr_peak, total=lr_total)
        gnorm = global_norm(grads)
        state = _update(state, grads, gnorm, lr=lr, b1=0.9, b2=0.95,
                        eps=1e-8, weight_decay=0.1, clip_norm=1.0)
        for p in own.values():
            p.grad = None
        return state, {"loss": loss, "lr": lr, "gnorm": gnorm}

    return train_step
