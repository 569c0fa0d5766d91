"""GPipe-style pipeline parallelism over a mesh axis (port of
`repro.runtime.pipeline`).

The layer stack is split into `n_stages` contiguous stages; stage s runs
on rank s of the mesh axis `axis` (one process a rank).  M microbatches
go through the classic GPipe schedule: T = M + P - 1 ticks, activations
hopping stage -> stage + 1 each tick.  The hop is a differentiable
`torch.autograd.Function` (its forward `batch_isend_irecv` to s + 1 and
from s - 1, its backward the reverse hop), so `backward()` through the
loop runs the reverse schedule, as `jax.grad` through the reference's
`ppermute` does.  The last stage's outputs are then surfaced on every
rank by an all-reduce whose backward hands each rank's gradient on (the
reference's `psum` of its replicated output), so a loss that every rank
computes from the replicated output gives the gradients of the layers
applied in sequence.
"""

from __future__ import annotations

import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L // n_stages, ...)
    (a tensor or a dict of them)."""
    def re(x):
        n_layers = x.shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers do not split into "
                             f"{n_stages} stages")
        return x.reshape((n_stages, n_layers // n_stages) + x.shape[1:])

    return _tree_map(re, stacked_params)


def _exchange(send, to_rank, from_rank, group):
    """Send `send` to `to_rank` and receive a tensor like it from
    `from_rank` (either None: no such peer) in one batch; returns what
    was received (zeros with no sender)."""
    import torch.distributed as dist

    recv = torch.zeros_like(send)
    ops = []
    if to_rank is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to_rank, group))
    if from_rank is not None:
        ops.append(dist.P2POp(dist.irecv, recv, from_rank, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


class _Hop(torch.autograd.Function):
    """One tick's hop: this stage's activation goes to the next stage,
    the previous stage's comes in (zeros at stage 0).  Backward sends the
    incoming gradient back to the previous stage and receives the next
    stage's (zeros at the last stage)."""

    @staticmethod
    def forward(ctx, cur, prev_rank, next_rank, group):
        ctx.peers = (prev_rank, next_rank, group)
        return _exchange(cur, next_rank, prev_rank, group)

    @staticmethod
    def backward(ctx, grad_recv):
        prev_rank, next_rank, group = ctx.peers
        grad = _exchange(grad_recv, prev_rank, next_rank, group)
        return grad, None, None, None


class _Tie(torch.autograd.Function):
    """x unchanged, made to depend on `dep` with a zero gradient (the
    reference's `jnp.where` keeps the unselected operand in the graph the
    same way): every tick's hop then lies on one chain of the graph on
    every rank, so each rank runs every hop's backward, in the same
    order."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.dep
        return grad, torch.zeros(shape, dtype=dtype, device=device)


class _Surface(torch.autograd.Function):
    """The last stage's outputs on every rank: forward all-reduces the
    stage's outputs (zeros on every other stage); backward hands each
    rank's own gradient back unchanged.  A loss that every rank computes
    from the replicated output gives every rank the same gradient, which
    the last stage's backward takes as the output's, as the reference's
    `shard_map` transposes its replicated output."""

    @staticmethod
    def forward(ctx, mine, group):
        import torch.distributed as dist

        out = mine.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gpipe_apply(stage_params, x_mb, *, mesh, stage_fn, axis: str = "stage"):
    """Run microbatches through the pipeline.

    stage_params: leaves (n_stages, layers_per_stage, ...) (a tensor or a
    dict of them); this rank runs index s, its place on `axis` of `mesh`
    (a DeviceMesh).  x_mb: (M, mb, S, D) microbatched activations, the
    same on every rank.  stage_fn(params_local, x) applies one stage's
    layers.  Returns (M, mb, S, D) outputs of the final stage on every
    rank."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)

    def peer(s):
        return dist.get_global_rank(group, s) if 0 <= s < n_stages else None

    prev_rank, next_rank = peer(stage - 1), peer(stage + 1)
    params_local = _tree_map(lambda t: t[stage], stage_params)
    n_mb = x_mb.shape[0]
    last = stage == n_stages - 1
    # the first hop's input requires grad on every rank, so every hop has
    # a backward
    cur = torch.zeros_like(x_mb[0]).requires_grad_(torch.is_grad_enabled())
    outs = []
    for t in range(n_mb + n_stages - 1):
        recv = _Hop.apply(cur, prev_rank, next_rank, group)
        inp = (_Tie.apply(x_mb[min(t, n_mb - 1)], recv) if stage == 0
               else recv)
        if stage <= t < stage + n_mb:       # active: this tick's microbatch
            cur = stage_fn(params_local, inp)
            if last:
                outs.append(cur)
        else:
            cur = _Tie.apply(torch.zeros_like(x_mb[0]), recv)
    mine = (torch.stack(outs) if last
            else _Tie.apply(torch.zeros_like(x_mb), cur))
    return _Surface.apply(mine, group)
