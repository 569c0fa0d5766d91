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
number of `b{j}`), and `shared`.  Whisper's tree (`embed`, `pos_dec`,
and `enc` / `dec`, each with its layers stacked under `blocks` and its
final norm under `ln`) maps to `{enc,dec}.blocks.{i}.*` and
`{enc,dec}.ln.*`.
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


ENCDEC_TOP = ("embed", "pos_dec", "enc", "dec")


def _stack_from_jax(out: dict, part: str, tree: dict) -> None:
    """One whisper stack ({blocks (stacked), ln}) into `out`."""
    extra = set(tree) - {"blocks", "ln"}
    if extra:
        raise ValueError(f"unknown {part} parameters {sorted(extra)}")
    leaves = _flatten(tree["blocks"])
    depths = {a.shape[0] if a.ndim else None for a in leaves.values()}
    if len(depths) != 1 or None in depths:
        raise ValueError(f"{part} block leaves must share one leading "
                         f"layers axis, got {sorted(depths, key=str)}")
    (n,) = depths
    for name, a in leaves.items():
        for i in range(n):
            out[f"{part}.blocks.{i}.{name}"] = _tensor(a[i])
    for name, a in _flatten(tree["ln"]).items():
        out[f"{part}.ln.{name}"] = _tensor(a)


def _encdec_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    extra = set(tree) - set(ENCDEC_TOP)
    if extra:
        raise ValueError(f"unknown top-level parameters {sorted(extra)}")
    out = {"embed": _tensor(tree["embed"]),
           "pos_dec": _tensor(tree["pos_dec"])}
    for part in ("enc", "dec"):
        _stack_from_jax(out, part, tree[part])
    return out


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy or torch leaves) -> the port's
    state dict (a torch leaf's layers are views of it).  Every leaf lands
    in exactly one tensor; a leaf or key it cannot place raises
    ValueError."""
    if "enc" in tree or "dec" in tree:
        return _encdec_from_jax(tree)
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


def _stacked(layers: dict[int, dict], what: str) -> dict:
    """{i: {name: t}} with i = 0..n-1 and the same names -> {name:
    stacked (n, ...)}."""
    if sorted(layers) != list(range(len(layers))):
        raise ValueError(f"{what} layers {sorted(layers)} are not "
                         f"0..{len(layers) - 1}")
    names = layers[0].keys() if layers else ()
    for i, leaves in layers.items():
        if leaves.keys() != names:
            raise ValueError(f"{what} layer {i} does not match layer 0's "
                             "parameters")
    return {name: torch.stack([layers[i][name] for i in range(len(layers))])
            for name in names}


def _encdec_to_jax(params: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    layers: dict[str, dict[int, dict]] = {"enc": {}, "dec": {}}
    for key, t in params.items():
        head, _, rest = key.partition(".")
        t = t.detach().cpu()
        sub, _, leaf = rest.partition(".")
        if head in ("embed", "pos_dec") and not rest:
            tree[head] = t
        elif head in layers and sub == "blocks":
            i, _, name = leaf.partition(".")
            layers[head].setdefault(int(i), {})[name] = t
        elif head in layers and sub == "ln" and leaf:
            _nest(tree.setdefault(head, {}).setdefault("ln", {}), leaf, t)
        else:
            raise ValueError(f"unknown parameter {key!r}")
    for part, ls in layers.items():
        blocks = tree.setdefault(part, {}).setdefault("blocks", {})
        for name, t in _stacked(ls, part).items():
            _nest(blocks, name, t)
    return tree


def params_to_jax(params: dict[str, torch.Tensor], per: int) -> dict:
    """The port's state dict (or a dict of moments keyed like it) -> the
    reference's parameter tree: `blocks.{s * per + j}.{name}` stacked over
    s into `blocks/b{j}/{name}` (nested dicts), `shared.{name}` under
    `shared`, `embed` and `final_ln` at the top (whisper's: `embed`,
    `pos_dec`, `enc` and `dec`, whatever `per` says).  Leaves are CPU
    tensors in their own dtype (`.numpy()` gives the reference's arrays,
    bf16 aside)."""
    if "pos_dec" in params:
        return _encdec_to_jax(params)
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
