"""Weight conversion between the reference's parameter tree and the
port's state dict.

`params_from_jax` takes the JAX package's decoder parameter tree as numpy
arrays (`model.init(key)[0]` with every leaf passed through `np.asarray`)
and returns the port's state dict, so both packages can run on the same
weights; `params_to_jax` is its inverse, which the checkpoint writes
through so that both packages store the same leaves.  The reference
stacks each super-block position's leaves on a leading (n_supers,) axis
under `blocks/b{j}` and keeps the hybrid's shared block under `shared`;
the port keeps one module per layer, `blocks.{s * per + j}` (per = the
number of `b{j}`), and `shared`.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy or torch leaves) -> the port's
    state dict (a torch leaf's layers are views of it).  Every leaf lands
    in exactly one tensor; a leaf or key it cannot place raises
    ValueError."""
    extra = set(tree) - {"embed", "final_ln", "blocks", "shared"}
    if extra:
        raise ValueError(f"unknown top-level parameters {sorted(extra)}")
    blocks = tree["blocks"]
    per = len(blocks)
    if set(blocks) != {f"b{j}" for j in range(per)}:
        raise ValueError(f"block positions {sorted(blocks)} are not "
                         f"b0..b{per - 1}")
    out = {"embed": _tensor(tree["embed"]),
           "final_ln": _tensor(tree["final_ln"])}
    stacked = {j: _flatten(blocks[f"b{j}"]) for j in range(per)}
    depths = {a.shape[0] if a.ndim else None
              for leaves in stacked.values() for a in leaves.values()}
    if len(depths) != 1 or None in depths:
        raise ValueError(f"block leaves must share one leading n_supers "
                         f"axis, got {sorted(depths, key=str)}")
    (ns,) = depths
    for j, leaves in stacked.items():
        for name, a in leaves.items():
            for s in range(ns):
                out[f"blocks.{s * per + j}.{name}"] = _tensor(a[s])
    for name, a in _flatten(tree.get("shared", {})).items():
        out[f"shared.{name}"] = _tensor(a)
    return out


def _nest(tree: dict, name: str, value) -> None:
    *heads, leaf = name.split(".")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[leaf] = value


def params_to_jax(params: dict[str, torch.Tensor], per: int) -> dict:
    """The port's state dict (or a dict of moments keyed like it) -> the
    reference's parameter tree: `blocks.{s * per + j}.{name}` stacked over
    s into `blocks/b{j}/{name}` (nested dicts), `shared.{name}` under
    `shared`, `embed` and `final_ln` at the top.  Leaves are CPU tensors
    in their own dtype (`.numpy()` gives the reference's arrays, bf16
    aside)."""
    tree: dict = {}
    layers: dict[int, dict[str, torch.Tensor]] = {}
    for key, t in params.items():
        head, _, rest = key.partition(".")
        t = t.detach().cpu()
        if head == "blocks":
            i, _, name = rest.partition(".")
            layers.setdefault(int(i), {})[name] = t
        elif head == "shared":
            _nest(tree.setdefault("shared", {}), rest, t)
        elif head in ("embed", "final_ln") and not rest:
            tree[head] = t
        else:
            raise ValueError(f"unknown parameter {key!r}")
    if sorted(layers) != list(range(len(layers))) or len(layers) % per:
        raise ValueError(f"layers {sorted(layers)} do not make whole "
                         f"super-blocks of {per}")
    ns = len(layers) // per
    blocks = tree.setdefault("blocks", {})
    for j in range(per):
        names = layers[j].keys()
        for s in range(ns):
            if layers[s * per + j].keys() != names:
                raise ValueError(f"layer {s * per + j} does not match "
                                 f"layer {j}'s parameters")
        for name in names:
            _nest(blocks.setdefault(f"b{j}", {}), name, torch.stack(
                [layers[s * per + j][name] for s in range(ns)]))
    return tree
