"""Weight conversion from the reference's parameter tree.

`params_from_jax` takes the JAX package's decoder parameter tree as numpy
arrays (`model.init(key)[0]` with every leaf passed through `np.asarray`)
and returns the port's state dict, so both packages can run on the same
weights.  The reference stacks each super-block position's leaves on a
leading (n_supers,) axis under `blocks/b{j}` and keeps the hybrid's
shared block under `shared`; the port keeps one module per layer,
`blocks.{s * per + j}` (per = the number of `b{j}`), and `shared`.
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
            out[name] = np.asarray(v)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy leaves) -> the port's state dict.
    Every leaf lands in exactly one tensor; a leaf or key it cannot place
    raises ValueError."""
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
