"""Logical-axis -> mesh-axis sharding rules (port of
`repro.runtime.sharding`; MaxText-style, with fallbacks).

Parameters and activations are annotated with *logical* axis names
("vocab", "heads", "mlp", "experts", "batch", "seq", ...).  A RuleSet maps
each logical name to a mesh axis (or tuple of axes).  `spec_for` checks
divisibility: a dimension that cannot be evenly sharded falls back to
replication (e.g. 8 KV heads on a 16-way model axis), never to an error —
this is what lets one rule set serve every architecture in the pool.

A spec is `PartitionSpec`, a tuple with one entry per leading dim (None,
an axis name, or a tuple of axis names) that equals the reference's
`jax.sharding.PartitionSpec` entry for entry.  `placements` maps it to
DTensor placements over a `DeviceMesh`.  The mesh of `spec_for` is
anything `launch.mesh.mesh_axes` reads.  `NamedSharding` holds (mesh,
spec, placements) for one tensor; `tree_shardings` and `zero_shardings`
give one for every leaf of a tree, as the reference's do.

An active-mesh context (`activation_sharding`) makes
`constrain(x, logical_axes)` redistribute a DTensor to its spec; outside
the context, and for a plain tensor, it returns x unchanged.  The models
run on DTensors through the helpers below it, each the identity on a
plain tensor: `replicated_like` makes a tensor the model builds for
itself (RoPE tables, masks, offsets) a replicated DTensor on the mesh of
the activation it meets; `to_local_at` / `from_local_at` bracket a
region that runs on local shards (the attention core, the MoE, the SSM),
where `sum_over` sums the ranks' parts of an output and `sum_grad` the
gradient of what each rank holds whole but uses a part of; `sum_to` and
`reduce_to` reduce a partial sum to a layout by explicit collectives;
`fsdp_gather` gathers a trained weight where FSDP splits it along the
rows it meets (never the rows); `batch_rows` takes a microbatch's rows
by an all-to-all; `matmul`, `reduce_partial` and `seq_whole` gather
where DTensor has no working strategy (listed in PERF.md).  No helper
asks DTensor to move a shard into a partial sum, forward or backward:
torch 2.11's DTensor refuses that move ("redistribute from S(d) to
P(sum) not supported yet").
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from dataclasses import dataclass

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..launch.mesh import mesh_axes

# default logical -> mesh-axis rules (single- and multi-pod)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),         # Megatron-SP: activations shard sequence
    # KV caches shard sequence over data AND model (SP decode): with GQA
    # kv_heads often < model-axis size (replicated fallback), the sequence
    # dim is what keeps the largest decode caches inside a card
    "kv_seq": ("data", "model"),
    "vocab": ("model",),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "layers": (),
    "frames": (),
    "image": (),
}


class PartitionSpec(tuple):
    """One entry per leading dim: None (replicated), an axis name, or a
    tuple of axis names (the dim split over each in turn).  A one-name
    tuple is stored as the name, as the reference's spec stores it."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class RuleSet:
    rules: tuple = tuple(sorted(DEFAULT_RULES.items()))

    def as_dict(self) -> dict:
        return dict(self.rules)

    def override(self, **kw) -> "RuleSet":
        d = self.as_dict()
        for k, v in kw.items():
            d[k] = tuple(v) if not isinstance(v, str) else (v,)
        return RuleSet(tuple(sorted(d.items())))


def spec_for(logical_axes, shape, mesh,
             rules: RuleSet | None = None) -> PartitionSpec:
    """PartitionSpec for one array, with divisibility fallbacks."""
    rules_d = (rules or RuleSet()).as_dict()
    axes = mesh_axes(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical_axes, strict=False):
        assigned = None
        if name is not None:
            for axis in rules_d.get(name, ()):
                if axis in axes and axis not in used:
                    size = axes[axis]
                    if dim % size == 0 and dim >= size:
                        # composite assignment (e.g. batch over pod+data):
                        # the axes accumulate for this dim
                        if assigned is None:
                            assigned = []
                        assigned.append(axis)
                        used.add(axis)
                        dim //= size
        out.append(tuple(assigned) if assigned else None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_specs(axes_tree, shape_tree, mesh, rules=None):
    """`spec_for` of every leaf: `axes_tree` a (nested) dict of logical
    axes tuples, `shape_tree` the same keys with tensors or shapes."""
    if _is_axes(axes_tree):
        return spec_for(axes_tree, _shape(shape_tree), mesh, rules)
    return {k: tree_specs(v, shape_tree[k], mesh, rules)
            for k, v in axes_tree.items()}


def zero_spec(spec: PartitionSpec, shape, mesh,
              axis: str = "data") -> PartitionSpec:
    """ZeRO-1: additionally shard the largest replicated dim over `axis`
    (optimizer moments: every data shard owns a slice)."""
    axes = mesh_axes(mesh)
    if axis not in axes:
        return spec
    size = axes[axis]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries if e for a in
            ((e,) if isinstance(e, str) else e)}
    if axis in used:
        return spec
    best, best_dim = -1, -1
    for i, (dim, e) in enumerate(zip(shape, entries, strict=True)):
        if e is None and dim % size == 0 and dim >= size and dim > best:
            best, best_dim = dim, i
    if best_dim < 0:
        return spec
    entries[best_dim] = axis
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of `spec` over `mesh`, one per mesh dim:
    `Shard(d)` on each mesh dim that tensor dim d is split over,
    `Replicate()` elsewhere.  A composite entry must name its axes in the
    mesh's dim order (DTensor splits a dim over several mesh dims in that
    order); any other order raises ValueError."""
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"{spec}: mesh axes {missing} are not in the "
                             f"mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"{spec}: dim {dim} splits over {axes}, out of "
                             f"the mesh's order {names}; DTensor cannot "
                             "express it without a strided shard")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """One tensor's sharding: the mesh, its spec and the DTensor
    placements of that spec (the port's `jax.sharding.NamedSharding`)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _map_specs(fn, specs):
    if isinstance(specs, PartitionSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def tree_shardings(axes_tree, shape_tree, mesh, rules=None):
    """A `NamedSharding` for every leaf: its `spec_for` on `mesh`."""
    return _map_specs(lambda s: NamedSharding(mesh, s),
                      tree_specs(axes_tree, shape_tree, mesh, rules))


def zero_shardings(axes_tree, shape_tree, mesh, rules=None, axis="data"):
    """A `NamedSharding` for every leaf: its spec with `axis` added on the
    largest replicated dim (`zero_spec`)."""
    def leaf(spec, shp):
        if isinstance(spec, PartitionSpec):
            return NamedSharding(mesh, zero_spec(spec, _shape(shp), mesh,
                                                 axis))
        return {k: leaf(v, shp[k]) for k, v in spec.items()}

    return leaf(tree_specs(axes_tree, shape_tree, mesh, rules), shape_tree)


# ------------------------------------------------------- activation context
_ctx = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, rules: RuleSet | None = None):
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules or RuleSet())
    try:
        yield
    finally:
        _ctx.state = prev


def active_rules():
    """(mesh, rules) of the active `activation_sharding`, or None."""
    return getattr(_ctx, "state", None)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def mesh_group(mesh):
    """The process group of all of the mesh's ranks (its dims flattened
    into one), made with every dispatch mode set aside: a new
    `DeviceMesh` builds its rank tensor, which a `FakeTensorMode` (a dry
    run) refuses."""
    from torch.utils._python_dispatch import _disable_current_modes

    if mesh.ndim == 1:
        return mesh.get_group(0)
    with _disable_current_modes():
        return mesh._flatten().get_group()


def _chunk_ranges(total: int, start: int, sizes) -> list:
    """[lo, hi) of each coordinate's rows, row-major over mesh dims of
    `sizes`, when `total` rows from `start` are split over them as
    DTensor splits one tensor dim (torch.chunk's sizes, the first mesh
    dim outermost)."""
    out = []
    for coord in itertools.product(*(range(k) for k in sizes)):
        lo, n = start, total
        for k, c in zip(sizes, coord, strict=True):
            step = -(-n // k)
            lo += min(c * step, n)
            n = max(0, min(step, n - c * step))
        out.append((lo, lo + n))
    return out


def batch_rows(x, lo: int, hi: int):
    """Rows [lo, hi) of a batch of data `x` (no gradient).  For a DTensor
    split on its dim 0, each rank's rows of the slice come from the ranks
    that hold them by one all-to-all over the mesh dims that split the
    rows (DTensor's own slice of a split dim gathers the whole batch on
    every rank first): at x's placements when the slice's rows split
    evenly over those ranks, else whole on each of them (DTensor
    flattens no dim split unevenly).  Anything else: `x[lo:hi]`."""
    if not is_dtensor(x):
        return x[lo:hi]
    mesh, pl = x.device_mesh, x.placements
    dims = [i for i, p in enumerate(pl)
            if isinstance(p, Shard) and p.dim == 0 and mesh.size(i) > 1]
    if not dims:
        return x[lo:hi]
    sizes = [mesh.size(i) for i in dims]
    have = _chunk_ranges(x.shape[0], 0, sizes)
    if (hi - lo) % math.prod(sizes) == 0:
        want = _chunk_ranges(hi - lo, lo, sizes)
    else:
        want = [(lo, hi)] * len(have)
        pl = tuple(Replicate() if i in dims else p for i, p in enumerate(pl))
    me = 0
    for i in dims:
        me = me * mesh.size(i) + mesh.get_local_rank(i)
    (a, b), (c, d) = have[me], want[me]
    send = [max(0, min(b, w1) - max(a, w0)) for w0, w1 in want]
    recv = [max(0, min(h1, d) - max(h0, c)) for h0, h1 in have]
    local = x.to_local()
    rows = torch.cat([local[max(a, w0) - a:][:n]
                      for (w0, _), n in zip(want, send, strict=True)])
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            group = mesh[tuple(mesh.mesh_dim_names[i] for i in dims)
                         ]._flatten().get_group()
    got = funcol.wait_tensor(funcol.all_to_all_single(rows, recv, send,
                                                      group))
    shape = (hi - lo, *x.shape[1:])
    return DTensor.from_local(got, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def local_shape_and_offset(shape, mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    `shape` at `placements` on `mesh`, as DTensor computes them, with
    every dispatch mode set aside: DTensor reads the mesh coordinate
    through tensor ops on the host, which a `FakeTensorMode` (a dry run)
    refuses as data-dependent, and which are no work of the step."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        local, off = compute_local_shape_and_global_offset(shape, mesh,
                                                           placements)
    return tuple(local), tuple(off)


def replicated_like(t, ref):
    """`t`, a tensor the model makes for itself, as a DTensor replicated
    on the mesh of `ref` when `ref` is a DTensor; else `t` itself."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _gather_where(x, gather):
    """DTensor `x` redistributed with each partial placement reduced and
    each placement p of mesh dim i where gather(i, p) made `Replicate()`;
    anything else as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() or gather(i, p) else p
        for i, p in enumerate(x.placements)))


def reduce_partial(x):
    """A DTensor with its partial placements reduced to `Replicate()` (the
    embedding over a vocab-sharded table comes out partial on that mesh
    dim); anything else as it is."""
    return _gather_where(x, lambda i, p: False)


def seq_whole(x):
    """A (B, S, ...) DTensor with its sequence (dim 1) gathered whole and
    its shards over mesh dims of one rank dropped (they hold the whole
    dim already), before a matmul flattens B and S into rows: DTensor
    refuses to merge two sharded dims, or a sharded dim of size one.
    Anything else as it is."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    mesh = x.device_mesh
    return _gather_where(x, lambda i, p: isinstance(p, Shard) and (
        p.dim == 1 or mesh.size(i) == 1))


class _GradAtOutput(torch.autograd.Function):
    """The identity, whose backward hands the gradient on at the
    placements its input had in the forward (replicated where that was
    partial: the gradient of a pending sum is the same on every rank)."""

    @staticmethod
    def forward(ctx, y):
        ctx.mesh = y.device_mesh
        ctx.placements = unpartial(y)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def fsdp_gather(w, x):
    """DTensor `w`, a weight being trained (grad mode on, `w` requiring
    grad), gathered on each mesh dim (of more than one rank) that splits
    it and also splits x's rows, any dim of x but its last: FSDP
    all-gathers the weight, so that a product keeps x's batch shard and
    the weight's gradient comes back to its shard by a reduce-scatter
    (left to itself, DTensor may instead gather x's batch and leave the
    product partial, the batch's whole product on every rank).  Anything
    else as it is: without autograd (prefill, decode) DTensor's own
    choice stands, which moves a decode's few rows, not the weights."""
    if not (is_dtensor(w) and is_dtensor(x) and w.requires_grad
            and torch.is_grad_enabled()):
        return w
    rows = {i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim < x.dim() - 1
            and x.device_mesh.size(i) > 1}
    return _gather_where(w, lambda i, p: i in rows and isinstance(p, Shard))


def matmul(x, w):
    """`x @ w`.  On a mesh: x's rows made safe to flatten (`seq_whole`),
    `w` gathered where FSDP splits it along x's rows (`fsdp_gather`), and
    the product's gradient brought back to the product's own placements
    before the matmul's backward flattens it (the gradient arriving from
    the residual stream is sharded on batch and sequence at once)."""
    if not is_dtensor(x):
        return x @ w
    x = seq_whole(x)
    return _GradAtOutput.apply(x @ fsdp_gather(w, x))


def _all_reduce(t, mesh, dims):
    for i in dims:
        t = funcol.all_reduce(t, "sum", mesh.get_group(i))
    return funcol.wait_tensor(t)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dims):
        return _all_reduce(t.contiguous(), mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.dims), None, None


def sum_over(t, mesh, dims):
    """Local tensor `t`, a part of a sum, summed over the ranks of the
    mesh dims `dims` (an all-reduce); its gradient passes unchanged, as
    every part had the same."""
    return _SumOver.apply(t, mesh, tuple(dims)) if dims else t


def sum_grad(t, mesh, dims):
    """Local tensor `t` unchanged, its gradient summed over the ranks of
    the mesh dims `dims`: for a tensor every rank holds whole but uses
    only a part of (each rank's gradient is then a part of the sum)."""
    return _SumGrad.apply(t, mesh, tuple(dims)) if dims else t


class _SumTo(torch.autograd.Function):
    """Local `t`, a part of a sum over the mesh dims `dims`, summed into
    the layout `target` gives those dims: a reduce-scatter on tensor dim
    d where it is `Shard(d)`, an all-reduce where it is `Replicate()`,
    the mesh dims in their order (DTensor nests a dim's shards the first
    mesh dim outermost).  Backward: the all-gathers, in reverse order (a
    reduce-scatter's gradient is the gathered gradient; an all-reduce's
    is the gradient itself, the same on every rank)."""

    @staticmethod
    def forward(ctx, t, mesh, dims, target):
        ctx.mesh, ctx.dims, ctx.target = mesh, dims, target
        t = t.contiguous()
        for i in dims:
            group = mesh.get_group(i)
            if isinstance(target[i], Shard):
                t = funcol.reduce_scatter_tensor(t, "sum", target[i].dim,
                                                 group)
            else:
                t = funcol.all_reduce(t, "sum", group)
            t = funcol.wait_tensor(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for i in reversed(ctx.dims):
            if isinstance(ctx.target[i], Shard):
                g = funcol.wait_tensor(funcol.all_gather_tensor(
                    g, ctx.target[i].dim, ctx.mesh.get_group(i)))
        return g, None, None, None


def sum_to(t, ref, dims, at, target):
    """Local tensor `t`, this rank's shard at `at` placements of a part of
    a sum over the ranks of the mesh dims `dims`, as the DTensor of the
    sum at `target` placements on `ref`'s mesh: each summed mesh dim
    reduced straight into its target placement by an explicit collective
    (`_SumTo`: a reduce-scatter where `target` shards it, an all-reduce
    where it replicates it), the other mesh dims then redistributed from
    `at` to `target` (moves without a partial sum).  The sum has `ref`'s
    global shape.  Its gradient is the gradient at `target`, gathered.  A
    plain `ref`: `t` itself."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    dims = tuple(i for i in dims if mesh.size(i) > 1)
    target = tuple(target)
    for i in dims:
        if isinstance(target[i], Shard) and any(
                isinstance(at[j], Shard) and at[j].dim == target[i].dim
                for j in range(i + 1, mesh.ndim)):
            raise ValueError(f"sum_to: mesh dim {i} would split tensor dim "
                             f"{target[i].dim} outside a later mesh dim's "
                             f"split of it ({tuple(at)} -> {target})")
    mid = tuple(target[i] if i in dims else p for i, p in enumerate(at))
    out = from_local_at(_SumTo.apply(t, mesh, dims, target) if dims else t,
                        ref, mid, ref.shape)
    return out if mid == target else out.redistribute(mesh, target)


def reduce_to(y, target):
    """DTensor `y`, partial (a sum) on some mesh dims, at `target`
    placements: each partial dim reduced straight into its target
    placement (`sum_to`: a reduce-scatter or an all-reduce) instead of
    by DTensor's redistribute, whose backward of a partial-to-shard move
    asks for a shard-to-partial one.  A `y` with no partial placement is
    redistributed to `target`; anything else is returned as it is."""
    if not is_dtensor(y):
        return y
    target = tuple(target)
    dims = [i for i, p in enumerate(y.placements) if p.is_partial()]
    if not dims:
        return y if y.placements == target else y.redistribute(
            y.device_mesh, target)
    if any(y.placements[i] != Partial("sum") for i in dims):
        raise ValueError(f"reduce_to: only a partial sum reduces here, "
                         f"not {y.placements}")
    at = unpartial(y)
    return sum_to(y.to_local(grad_placements=at), y, dims, at, target)


def unpartial(x) -> tuple:
    """DTensor `x`'s placements with each partial one made `Replicate()`."""
    return tuple(Replicate() if p.is_partial() else p for p in x.placements)


def replicated(x) -> tuple:
    """Placements replicating DTensor `x` on every mesh dim."""
    return (Replicate(),) * x.device_mesh.ndim


def batch_only(x) -> tuple:
    """`x`'s placements with every shard but the batch dim's (dim 0)
    replaced by `Replicate()`."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def to_local_at(x, target):
    """A DTensor redistributed to `target` placements, and its local
    shard (with autograd through both); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, tuple(target)).to_local()


def from_local_at(t, ref, target, shape=None):
    """The inverse of `to_local_at`: `t`, a local shard, as the DTensor
    at `target` placements on `ref`'s mesh; `t` itself when `ref` is a
    plain tensor.  The global shape is `shape`, or else the local one
    scaled by the mesh dims that shard it (every rank's shard then must
    be the same size)."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    if shape is None:
        shape = list(t.shape)
        for i, p in enumerate(target):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
    shape = list(shape)
    # contiguous: DTensor's reshape of the result runs `view` on it
    return DTensor.from_local(t.contiguous(), mesh, tuple(target),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def argmax_last(x):
    """`torch.argmax(x, dim=-1)`; for a DTensor, as DTensor's own argmax
    does it over a split last dim (each rank's local argmax moved to its
    global index, the (value, index) pairs all-gathered over each mesh
    dim that splits the dim, the first largest kept), with the shard's
    offset read outside any dispatch mode: DTensor's reads it through
    host tensor ops, which a dry run's `FakeTensorMode` refuses."""
    if not is_dtensor(x):
        return torch.argmax(x, dim=-1)
    x = reduce_partial(x)
    mesh, pl, last = x.device_mesh, x.placements, x.dim() - 1
    local = x.to_local()
    idx = torch.argmax(local, dim=last, keepdim=True)
    split = [i for i, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == last]
    if split:
        val = local.gather(last, idx)
        idx = idx + local_shape_and_offset(x.shape, mesh, pl)[1][last]
        for i in reversed(split):          # the innermost shards first
            group = mesh.get_group(i)
            val = funcol.wait_tensor(funcol.all_gather_tensor(val, last,
                                                              group))
            idx = funcol.wait_tensor(funcol.all_gather_tensor(idx, last,
                                                              group))
        idx = idx.gather(last, torch.argmax(val, dim=last, keepdim=True))
    at = tuple(Replicate() if i in split else p for i, p in enumerate(pl))
    return from_local_at(idx[..., 0], x, at)


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def target_placements(x, logical_axes):
    """The placements of `logical_axes` for DTensor `x` under the active
    rules (the default rules on x's mesh outside a context)."""
    state = active_rules()
    rules = state[1] if state is not None else None
    mesh = x.device_mesh
    return _activation_placements(
        spec_for(logical_axes, x.shape, mesh, rules), mesh, x.shape)


def _activation_placements(spec, mesh, shape) -> tuple:
    """`placements(spec, mesh)` with a dim of size one left whole: only a
    mesh dim of one rank shards it (spec_for lets 1 % 1 pass), which
    moves no data, and DTensor cannot flatten such a dim into rows (a
    microbatch of one sequence)."""
    return tuple(Replicate() if isinstance(p, Shard) and shape[p.dim] == 1
                 else p for p in placements(spec, mesh))


def constrain(x, logical_axes):
    """Redistribute a DTensor to its spec if a mesh context is active; a
    plain tensor, or any tensor outside the context, is returned as is."""
    state = getattr(_ctx, "state", None)
    if state is None:
        return x
    if not isinstance(x, DTensor):
        return x
    mesh, rules = state
    spec = spec_for(logical_axes, x.shape, mesh, rules)
    return x.redistribute(mesh, _activation_placements(spec, mesh, x.shape))
