"""Weight conversion from the reference's parameter tree.

`params_from_jax` takes the JAX package's dense-LM parameter tree as
numpy arrays (`model.init(key)[0]` with every leaf passed through
`np.asarray`) and returns the port's state dict, so both packages can run
on the same weights.  The reference stacks every block leaf on a leading
(n_layers,) axis under `blocks/b0`; the port keeps one block per layer.
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


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy leaves) -> the port's state dict."""
    blocks = tree["blocks"]
    if set(blocks) != {"b0"} or "shared" in tree:
        raise NotImplementedError("only the dense super-block is ported")
    out = {"embed": torch.from_numpy(np.array(tree["embed"])),
           "final_ln": torch.from_numpy(np.array(tree["final_ln"]))}
    for name, stacked in _flatten(blocks["b0"]).items():
        for i in range(stacked.shape[0]):
            out[f"blocks.{i}.{name}"] = torch.from_numpy(
                np.array(stacked[i]))
    return out
