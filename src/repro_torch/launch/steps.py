"""Step functions and the model cell (port of `repro.launch.steps`: the
train step, the prefill step and the serve step, for every family; the
logical axes of the inputs and the decode cache; and `build_cell`, one
(arch x shape x mesh) step with the reference's shardings of its
parameters, optimizer moments, inputs and cache).

The model (`DecoderLM` or whisper's `Whisper`) holds its weights, and its
`forward` / `decode_step` take the family's inputs (whisper's prefill
batch carries `frames`).  A cell's step takes the reference's arguments
all the same (train: (state, batch); prefill: (params, batch); decode:
(params, token, cache, index[, image_embeds])) and checks that the
params are its model's own.  `build_cell` allocates nothing: its model
and its argument specs live on the "meta" device.  `place_cell` makes
the arguments real on a mesh, each a DTensor at its placements, and
puts the parameters into the model; the step then runs inside
`activation_sharding` on that mesh."""

from __future__ import annotations

import torch

from ..models import ShapeSpec, abstract_params, cache_specs, input_specs
from ..models.layers import logits_last
from ..models.transformer import DecoderLM, iter_lm
from ..models.whisper import Whisper, init_whisper
from ..optim.adamw import (DYN_COUNTER_INIT, TrainState,
                           abstract_opt_state, make_train_step)
from ..runtime.sharding import (NamedSharding, PartitionSpec, RuleSet,
                                activation_sharding, argmax_last,
                                is_dtensor, local_shape_and_offset,
                                spec_for, tree_shardings, zero_shardings)

__all__ = ["CACHE_AXES", "INPUT_AXES", "CellStep", "batch_shardings",
           "build_cell", "cache_shardings", "make_prefill_step",
           "make_serve_step", "make_train_step", "place_cell",
           "place_zeros"]

# logical axes for model inputs, by name
INPUT_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "seq", "embed"),
    "image_embeds": ("batch", "image", "embed"),
    "token": ("batch", None),
    "index": (),
}

# logical axes for decode-cache leaves, by leaf name
CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "xk": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "xv": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "conv_x": ("layers", "batch", None, "mlp"),
    "conv_B": ("layers", "batch", None, None),
    "conv_C": ("layers", "batch", None, None),
    "h": ("layers", "batch", "heads", None, None),
}


def batch_shardings(cfg, shape: ShapeSpec, mesh, rules: RuleSet) -> dict:
    return {k: NamedSharding(mesh, spec_for(INPUT_AXES[k], v.shape, mesh,
                                            rules))
            for k, v in input_specs(cfg, shape).items()}


def cache_shardings(cache_shapes, mesh, rules: RuleSet, name=None):
    """A `NamedSharding` for every leaf of a cache tree, by the leaf's
    name in CACHE_AXES (replicated when the name is not there or its
    axes do not fit the leaf)."""
    if isinstance(cache_shapes, dict):
        return {k: cache_shardings(v, mesh, rules, k)
                for k, v in cache_shapes.items()}
    nd = cache_shapes.dim()
    axes = CACHE_AXES.get(name, (None,) * nd)
    if len(axes) != nd:
        axes = (None,) * nd
    return NamedSharding(mesh, spec_for(axes, cache_shapes.shape, mesh,
                                        rules))


def make_prefill_step(model):
    """-> prefill_step(batch) -> (B, V) float32 logits at the last
    position of the prompt (the next token's), from `model.forward`
    (whisper: the decoder over the encoded `frames`)."""

    @torch.no_grad()
    def prefill_step(batch):
        h = model.forward(batch)
        head = getattr(model, "out_head", model.embed)
        return logits_last(h[:, -1], head.to(h.dtype))

    return prefill_step


def make_serve_step(model):
    """-> serve_step(token (B, 1), cache, index, image_embeds=None) ->
    (next_token (B, 1) int32, cache): one greedy decode step.  The model
    holds its weights, so there is no params argument; the cache is
    updated in place.  `image_embeds` reaches the model for the vlm
    family only, as in the reference; whisper's step attends the cross
    K/V its cache holds."""
    vlm = model.config.family == "vlm"

    def serve_step(token, cache, index: int, image_embeds=None):
        kw = {"image_embeds": image_embeds} if vlm else {}
        logits = model.decode_step(token, cache, index, **kw)
        next_token = argmax_last(logits).to(torch.int32)[:, None]
        return next_token, cache

    return serve_step


def _meta_model(cfg, params: dict):
    return (Whisper if cfg.family == "encdec" else DecoderLM)(cfg, params)


class CellStep:
    """One cell's step with the reference's arguments: `kind` "train"
    (state, batch) -> (state, metrics); "prefill" (params, batch) ->
    logits; "decode" (params, token, cache, index[, image_embeds]) ->
    (next_token, cache).  It runs inside `activation_sharding(mesh,
    rules)`; `model` is the model whose parameters the params must be."""

    def __init__(self, model, kind: str, mesh, rules: RuleSet):
        self.model, self.kind, self.mesh, self.rules = model, kind, mesh, rules
        self._train = (make_train_step(model) if kind == "train" else None)

    def _check(self, params: dict) -> None:
        own = dict(self.model.named_parameters())
        if params.keys() != own.keys() or any(
                params[k] is not p for k, p in own.items()):
            raise ValueError("the params are not this cell's model's")

    def __call__(self, *args):
        with activation_sharding(self.mesh, self.rules):
            if self.kind == "train":
                return self._train(*args)
            self._check(args[0])
            if self.kind == "prefill":
                return make_prefill_step(self.model)(args[1])
            token, cache, index, *img = args[1:]
            index = index.full_tensor() if is_dtensor(index) else index
            return make_serve_step(self.model)(token, cache, int(index),
                                               *img)


def build_cell(arch_cfg, shape: ShapeSpec, mesh, rules: RuleSet | None = None,
               *, fsdp: bool = True):
    """Everything needed to run one (arch x shape x mesh) cell, with
    nothing allocated.  Returns (fn, arg_specs, in_shardings, None): fn a
    `CellStep` over a model on the "meta" device, arg_specs meta tensors
    in the structure of fn's arguments (the params are the model's own
    meta parameters), in_shardings a `NamedSharding` for each.

    With `fsdp` (the default) the parameters are sharded as tensor
    parallel on "model" and also over "data" on their largest replicated
    dim (`zero_shardings`: FSDP / ZeRO-3, gathered where a layer uses
    them); `fsdp=False` keeps them tensor parallel only.  The AdamW
    moments are under `zero_shardings` either way (ZeRO-1), step and
    dyn_counter replicated."""
    rules = rules or RuleSet()
    shapes, paxes = abstract_params(arch_cfg)
    model = _meta_model(arch_cfg, shapes)
    pshapes = dict(model.named_parameters())
    if fsdp:
        pshard = zero_shardings(paxes, pshapes, mesh, rules)
    else:
        pshard = tree_shardings(paxes, pshapes, mesh, rules)
    bshard = batch_shardings(arch_cfg, shape, mesh, rules)
    bshapes = input_specs(arch_cfg, shape)
    repl = NamedSharding(mesh, PartitionSpec())
    fn = CellStep(model, shape.kind, mesh, rules)

    if shape.kind == "train":
        state_shapes = abstract_opt_state(pshapes, arch_cfg.optimizer_dtype)
        zshard = zero_shardings(paxes, pshapes, mesh, rules)
        state_shard = TrainState(params=pshard, m=zshard, v=zshard,
                                 step=repl, dyn_counter=repl)
        return fn, (state_shapes, bshapes), (state_shard, bshard), None

    if shape.kind == "prefill":
        return fn, (pshapes, bshapes), (pshard, bshard), None

    # decode
    b = shape.global_batch
    cache_shapes = cache_specs(arch_cfg, shape)
    cshard = cache_shardings(cache_shapes, mesh, rules)
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    tok_shard = NamedSharding(mesh, spec_for(("batch", None), (b, 1), mesh,
                                             rules))
    index = torch.empty((), dtype=torch.int32, device="meta")
    args = [pshapes, token, cache_shapes, index]
    shards = [pshard, tok_shard, cshard, repl]
    if arch_cfg.family == "vlm":
        img = bshapes["image_embeds"]
        args.append(img)
        shards.append(bshard["image_embeds"])
    return fn, tuple(args), tuple(shards), None


# ------------------------------------------------------------ placement
def _local(full: torch.Tensor, sharding: NamedSharding, device):
    """This rank's shard of `full` at the sharding's placements, as a
    DTensor (no collective: every rank holds `full`)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(device), sharding.mesh,
                             sharding.placements, src_data_rank=None)


def _zeros(spec: torch.Tensor, sharding: NamedSharding, device):
    """A DTensor of `spec`'s shape and dtype, zero, each rank allocating
    only its shard."""
    from torch.distributed.tensor import DTensor

    local, _ = local_shape_and_offset(spec.shape, sharding.mesh,
                                      sharding.placements)
    t = torch.zeros(local, dtype=spec.dtype, device=device)
    return DTensor.from_local(t, sharding.mesh, sharding.placements,
                              run_check=False, shape=spec.shape,
                              stride=torch.empty(spec.shape,
                                                 device="meta").stride())


def _place_tree(specs, shardings, values, device):
    """Every leaf of `specs` placed: from `values` (full tensors, numpy
    arrays or numbers, in the same structure) where given, else zero."""
    if isinstance(specs, dict):
        return {k: _place_tree(v, shardings[k],
                               None if values is None else values.get(k),
                               device)
                for k, v in specs.items()}
    if values is None:
        return _zeros(specs, shardings, device)
    full = torch.as_tensor(values).to(specs.dtype)
    if tuple(full.shape) != tuple(specs.shape):
        raise ValueError(f"a value of shape {tuple(full.shape)} for a leaf "
                         f"of shape {tuple(specs.shape)}")
    return _local(full, shardings, device)


def _place_params(model, shardings: dict, params, seed: int, device):
    """Put each parameter into `model` as a DTensor at its sharding: from
    `params` (full tensors, popped from the dict as each is placed, so a
    caller that hands its only reference over holds one full tensor at a
    time) or drawn from `seed` one layer at a time as `build(cfg,
    seed=seed)` draws them (each rank keeps its shard of each layer).
    The model was built on the meta device; its meta parameters are
    replaced, not materialised (`to_empty` would allocate every full
    tensor)."""
    cfg = model.config
    if params is None:
        if cfg.family == "encdec":
            source = iter(init_whisper(cfg, seed, device).items())
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            source = iter_lm(cfg, gen, device)
    else:
        source = ((k, params.pop(k)) for k in list(params))
    placed = set()
    for name, full in source:
        if name not in shardings:
            raise ValueError(f"{name} is not a parameter of {cfg.name}")
        meta = model.get_parameter(name)
        if tuple(full.shape) != tuple(meta.shape):
            raise ValueError(f"{name}: {tuple(full.shape)}, the model "
                             f"wants {tuple(meta.shape)}")
        dt = _local(full.to(cfg.param_dtype), shardings[name], device)
        del full
        _set_parameter(model, name, dt)
        placed.add(name)
    missing = set(shardings) - placed
    if missing:
        raise ValueError(f"no values for {sorted(missing)[:8]}")
    model._decode = None


def _set_parameter(model, name: str, value) -> None:
    from torch import nn

    head, _, leaf = name.rpartition(".")
    owner = model.get_submodule(head) if head else model
    owner.register_parameter(leaf, nn.Parameter(value))


def place_cell(fn: CellStep, arg_specs, in_shardings, values=(), *,
               params: dict | None = None, seed: int = 0, device="cuda"):
    """The cell's arguments, real, on its mesh: each a DTensor at its
    placements on `device` (each rank allocating its own shards).

    The parameters go into `fn.model` (from `params` or drawn from
    `seed`, see `_place_params`) and are the params of the arguments.
    `values` gives the arguments after the state / params in order, as
    full tensors or numpy arrays (the batch dict; the decode step's
    token, cache and index, and image_embeds for the vlm); a cache given
    as None, or a leaf of it missing, is made zero.  A train state's
    moments start at zero, step at 0 and dyn_counter at AdamW's initial
    value."""
    from ..device import resolve_device

    dev = resolve_device(device)
    model = fn.model
    first_shard = in_shardings[0]
    pshard = first_shard.params if fn.kind == "train" else first_shard
    _place_params(model, pshard, params, seed, dev)
    own = dict(model.named_parameters())
    rest = []
    for spec, shard, val in zip(arg_specs[1:], in_shardings[1:],
                                tuple(values) + (None,) * len(arg_specs),
                                strict=False):
        if val is None and fn.kind != "decode":
            raise ValueError("the batch must be given")
        rest.append(_place_tree(spec, shard, val, dev))
    if fn.kind != "train":
        return (own, *rest)
    st = arg_specs[0]
    state = TrainState(
        params=own,
        m=_place_tree(st.m, first_shard.m, None, dev),
        v=_place_tree(st.v, first_shard.v, None, dev),
        step=_place_tree(st.step, first_shard.step, 0, dev),
        dyn_counter=_place_tree(st.dyn_counter, first_shard.dyn_counter,
                                DYN_COUNTER_INIT, dev),
        per=getattr(model, "per", 1))
    return (state, *rest)


def place_zeros(fn: CellStep, arg_specs, in_shardings, *, index: int = 0,
                device="cuda"):
    """The cell's arguments as `place_cell` returns them, every one a
    zero DTensor at its placements (each rank allocating only its
    shards) and nothing drawn from a seed; the decode's index is the
    Python int `index`.  Under a `FakeTensorMode` this allocates nothing:
    the arguments of a dry run."""
    from ..device import resolve_device

    dev = resolve_device(device)
    model = fn.model
    first = in_shardings[0]
    pshard = first.params if fn.kind == "train" else first
    for name, meta in list(model.named_parameters()):
        _set_parameter(model, name, _zeros(meta, pshard[name], dev))
    model._decode = None
    own = dict(model.named_parameters())
    rest = [_place_tree(spec, shard, None, dev)
            for spec, shard in zip(arg_specs[1:], in_shardings[1:],
                                   strict=True)]
    if fn.kind == "decode":
        rest[2] = index
    if fn.kind != "train":
        return (own, *rest)
    st = arg_specs[0]
    state = TrainState(params=own, **{
        f: _place_tree(getattr(st, f), getattr(first, f), None, dev)
        for f in ("m", "v", "step", "dyn_counter")},
        per=getattr(model, "per", 1))
    return (state, *rest)
