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
anything `launch.mesh.mesh_axes` reads.

An active-mesh context (`activation_sharding`) makes
`constrain(x, logical_axes)` redistribute a DTensor to its spec; outside
the context, and for a plain tensor, it returns x unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

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
    from torch.distributed.tensor import Replicate, Shard

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


def constrain(x, logical_axes):
    """Redistribute a DTensor to its spec if a mesh context is active; a
    plain tensor, or any tensor outside the context, is returned as is."""
    state = getattr(_ctx, "state", None)
    if state is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = state
    spec = spec_for(logical_axes, x.shape, mesh, rules)
    return x.redistribute(mesh, placements(spec, mesh))
