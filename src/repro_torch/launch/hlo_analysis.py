"""The roofline terms of one step: its flops, its collectives and the
argument bytes a device holds (port of `repro.launch.hlo_analysis`; the
name is kept so that a reader finds the counterpart).

There is no HLO here: a step is eager PyTorch on DTensors.  `analyze_step`
runs it once under a `TorchDispatchMode` that sees every op on local
tensors, below DTensor's dispatch (a DTensor op is handed on to DTensor,
whose redistributions then run c10d functional collectives on local
shards).  It records each collective, by the byte rule of the
reference's `collective_bytes`, and counts each op's flops by
`torch.utils.flop_counter`'s table (FlopCounterMode's own `flop_registry`)
on the local shapes: the flops of one device, as XLA's `cost_analysis`
of a partitioned module gives them.  The argument bytes a device holds
are summed from the local shards of the placements (the reference's
`memory_analysis().argument_size_in_bytes`).

The same run gives the counterparts of XLA's "bytes accessed" and
`memory_analysis`.  The port runs unfused eager ops, so what its step
reads and writes is each op's inputs and outputs: `bytes_accessed` sums
them over every op on local tensors, but for ops that move no data (a
view, an op whose outputs all alias its inputs without writing them, an
uninitialised allocation, a wait on a collective).  Memory is counted by
storage: each storage an op creates is live from that op until the
storage is freed (a finalizer on it), so `temp_size_in_bytes` is the
peak of the bytes the step holds beyond its arguments (activations,
saved tensors, gradients, and the outputs live at that peak), and a card
holds at most `argument_size_in_bytes + temp_size_in_bytes`
(`peak_bytes`).  Fake tensors (a dry run) have storages of the same
sizes as real ones, so both give the same numbers.
"""

from __future__ import annotations

import contextlib
import heapq
import math
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# bytes per element, by torch dtype (the reference's table, by HLO name)
DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.bfloat16: 2, torch.float16: 2, torch.int16: 2, torch.uint16: 2,
    torch.float32: 4, torch.int32: 4, torch.uint32: 4,
    torch.float64: 8, torch.int64: 8, torch.uint64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# the c10d functional collectives a DTensor step issues (and their
# autograd forms, same names), by the reference's names; a step issues no
# point-to-point transfer, so "collective-permute" stays 0
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",    # DTensor's Shard(i) -> Shard(j)
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, t.element_size())


def collective_bytes(records) -> dict:
    """{bytes_by_type, counts_by_type, total_bytes, total_ops} of
    (kind, bytes) records, keyed by the reference's five names."""
    out = {c: 0 for c in COLLECTIVES}
    counts = {c: 0 for c in COLLECTIVES}
    for kind, n in records:
        out[kind] += n
        counts[kind] += 1
    return {"bytes_by_type": out, "counts_by_type": counts,
            "total_bytes": sum(out.values()),
            "total_ops": sum(counts.values())}


def _collective(func, args, out):
    """(kind, bytes) of a c10d functional op, or None for any other op.
    An all-gather counts its gathered result, a reduce-scatter its
    scattered result times the group size, any other its operand."""
    ns = func.namespace
    name = func._overloadpacket.__name__
    if ns not in _NAMESPACES:
        return None
    kind = _KINDS.get(name)
    if kind is None:
        if name in ("wait_tensor", "_wrap_tensor_autograd"):
            return None
        raise ValueError(f"a collective the analysis cannot class: {func}")
    if kind == "all-gather":
        return kind, _nbytes(out)
    if kind == "reduce-scatter":
        group = args[2]                     # (input, op, group_size, name)
        return kind, _nbytes(out) * int(group)
    return kind, _nbytes(args[0])


# ops that move no data: an output allocated and not written; the wait on
# a collective and its autograd wrapper (on a fake tensor they return a
# new storage, which stands for the collective's result, so it is kept)
_NO_DATA = ("empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd")


class _StepRecorder(TorchDispatchMode):
    """Records the collectives, flops, bytes accessed and live storage
    bytes of ops on local tensors; ops on DTensors, and on any other
    tensor subclass but a FakeTensor (a collective's result waiting for
    it, `AsyncCollectiveTensor`), are handed on to the subclass
    (returning NotImplemented), whose own local ops then come back here.
    Use it in a `with` block: leaving it detaches the finalizers of the
    storages still live.  With `top` > 0 it also keeps, at each new
    peak, the `top` largest storages live then: the op that made each,
    its shape, dtype and bytes (`peak_tensors`)."""

    def __init__(self, top: int = 0):
        super().__init__()
        self.top = top
        self.peak_tensors: list = []
        self._made: dict = {}           # storage key -> (op, shape, dtype, n)
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.records: list = []
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0                   # bytes of the storages ops created
        self.peak = 0
        self._owned: dict = {}          # storage key -> its finalizer
        self._lock = threading.Lock()   # backward may free on another thread
        self.paused = 0                 # inside DTensor's shape inference

    def add_flops(self, n: float) -> None:
        """FLOPs of a kernel launch, which no aten op shows."""
        self.flops += n

    def _free(self, key, n: int) -> None:
        with self._lock:
            self.live -= n
            self._owned.pop(key, None)
            self._made.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        kwargs = kwargs or {}
        if any(t is not torch.Tensor and not issubclass(t, FakeTensor)
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        # lift_fresh: a constant made on the host, which a real run
        # allocates before the op and a fake one in it
        if self.paused or name == "lift_fresh":
            return out
        rec = _collective(func, args, out)
        if rec is not None:
            self.records.append(rec)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = [*_leaves(args), *_leaves(kwargs)]
        outs = list(_leaves(out))
        # a storage's key: its StorageImpl, shared by every view of it
        held = {t.untyped_storage()._cdata for t in ins}
        new = {}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in held:
                new[st._cdata] = (st, t)
        with self._lock:
            for key, (st, t) in new.items():
                if key not in self._owned:
                    n = st.nbytes()
                    self._owned[key] = weakref.finalize(st, self._free, key,
                                                        n)
                    self.live += n
                    if self.top:
                        self._made[key] = (name, list(t.shape),
                                           str(t.dtype).removeprefix(
                                               "torch."), n)
            if self.live > self.peak and self.top:
                self.peak_tensors = [
                    dict(zip(("op", "shape", "dtype", "bytes"), m))
                    for m in heapq.nlargest(self.top, self._made.values(),
                                            key=lambda m: m[3])]
            self.peak = max(self.peak, self.live)
        if outs and name not in _NO_DATA and (new or
                                              func._schema.is_mutable):
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        return out

    def __exit__(self, *exc):
        with self._lock:
            for fin in self._owned.values():
                fin.detach()
            self._owned.clear()
            self._made.clear()
        return super().__exit__(*exc)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def local_bytes(tree) -> int:
    """Bytes of the tensors of a tree that this device holds: a DTensor's
    local shard, a plain tensor whole."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _leaves(tree))


def argument_bytes(arg_specs, in_shardings) -> int:
    """The bytes of a cell's arguments that one device holds, from the
    specs (meta tensors) and their `NamedSharding`s: each leaf's bytes
    over the product of the mesh axes its spec splits it on.  Counts
    without running anything (a dry run over a fake world)."""
    from ..launch.mesh import mesh_axes
    from ..runtime.sharding import NamedSharding

    def walk(spec, shard):
        if isinstance(shard, NamedSharding):
            axes = mesh_axes(shard.mesh)
            split = math.prod(
                axes[a] for e in shard.spec if e is not None
                for a in ((e,) if isinstance(e, str) else e))
            return _nbytes(spec) // split
        if isinstance(spec, dict):
            return sum(walk(v, shard[k]) for k, v in spec.items())
        if isinstance(spec, (list, tuple)):
            return sum(walk(v, s) for v, s in zip(spec, shard, strict=True))
        return sum(walk(getattr(spec, f), getattr(shard, f))
                   for f in ("params", "m", "v", "step", "dyn_counter"))

    return sum(walk(a, s) for a, s in zip(arg_specs, in_shardings,
                                          strict=True))


@contextlib.contextmanager
def _without_shape_inference(rec: _StepRecorder):
    """`rec` paused while DTensor infers an op's output shape: on a miss
    of its sharding cache, DTensor runs the op once more on fake tensors
    of the global shapes (`ShardingPropagator._propagate_tensor_meta*`),
    which is no work of the step (a step's first run would otherwise
    count each new op signature once more at its global size)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if n in vars(ShardingPropagator)), None)
    if name is None:
        raise RuntimeError("this torch's DTensor has no shape-inference "
                           "method that analyze_step knows to set aside")
    infer = vars(ShardingPropagator)[name]

    def paused(self, *a, **kw):
        rec.paused += 1
        try:
            return infer(self, *a, **kw)
        finally:
            rec.paused -= 1

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, infer)


def analyze_step(fn, *args, peak_tensors: int = 0) -> dict:
    """Run fn(*args) once and return {"flops": one device's flops (the
    aten ops' and those the port's kernels report),
    "bytes_accessed": the bytes its ops read and wrote, "collectives":
    `collective_bytes` of what it ran, "argument_bytes":
    `local_bytes(args)`, "memory_analysis": {argument_size_in_bytes,
    output_size_in_bytes (the result's local bytes), temp_size_in_bytes
    (the peak of the storage bytes the step created and held)},
    "peak_bytes": argument + temp, the most a device holds, "out": fn's
    result}; with `peak_tensors` > 0 also "peak_tensors", that many of
    the largest storages live at the peak (op, shape, dtype, bytes)."""
    from ..kernels import cuda_lib

    held = local_bytes(args)
    rec = _StepRecorder(peak_tensors)
    cuda_lib.FLOP_OBSERVERS.append(rec.add_flops)
    try:
        with _without_shape_inference(rec), rec:
            out = fn(*args)
    finally:
        cuda_lib.FLOP_OBSERVERS.remove(rec.add_flops)
    info = {"flops": float(rec.flops), "bytes_accessed": rec.bytes_accessed,
            "collectives": collective_bytes(rec.records),
            "argument_bytes": held,
            "memory_analysis": {"argument_size_in_bytes": held,
                                "output_size_in_bytes": local_bytes(out),
                                "temp_size_in_bytes": rec.peak},
            "peak_bytes": held + rec.peak, "out": out}
    if peak_tensors:
        info["peak_tensors"] = rec.peak_tensors
    return info


class _MeshShape:
    """A mesh of axis sizes only (what `spec_for` and `argument_bytes`
    read): counts without a process group."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape, strict=True))


def argument_table(multi_pod: bool = False) -> list[dict]:
    """The argument bytes a device holds for every arch x STANDARD_SHAPE
    cell on the production mesh's shape, FSDP and tensor parallel only,
    counted from the specs on the CPU."""
    from .. import configs
    from ..models import STANDARD_SHAPES
    from .mesh import HBM_BYTES, PRODUCTION_MESHES
    from .steps import build_cell

    mesh = _MeshShape(*PRODUCTION_MESHES[multi_pod])
    rows = []
    for name in configs.ARCHS:
        for shape in STANDARD_SHAPES:
            row = {"arch": name, "shape": shape.name}
            for fsdp in (True, False):
                _, args, shards, _ = build_cell(configs.get(name), shape,
                                                mesh, fsdp=fsdp)
                n = argument_bytes(args, shards)
                key = "fsdp" if fsdp else "tp_only"
                row[key] = n
                row[f"{key}_hbm_share"] = n / HBM_BYTES
            rows.append(row)
    return rows


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.hlo_analysis",
        description="argument bytes a card holds for every cell on the "
                    "production mesh (counted on the CPU from the specs)")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    for row in argument_table(args.multi_pod):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
