"""Elastic re-meshing: rebuild the mesh after a loss and re-shard state
(port of `repro.runtime.elastic`).

Checkpoints store full logical tensors (checkpoint/ckpt.py), so a restore
onto any mesh is a `distribute_tensor` of each full leaf with the new
mesh's placements.  `shrink_mesh` drops the failed ranks and finds the
largest (data, model) grid that still divides the model axis, with the
reference's arithmetic.  Where the reference's single controller just
drops devices, a torch job re-forms its world from the survivors (their
ranks renumbered in order), so `shrink_mesh` returns the grid of old
ranks and `Grid.build` makes its `DeviceMesh` in that re-formed world.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sharding import RuleSet, placements, tree_specs


@dataclass(frozen=True)
class Grid:
    """A (data, model) grid of ranks of the world before the loss.
    `shape` ({axis: size}) makes it a mesh to `spec_for`."""
    ranks: np.ndarray
    axis_names: tuple = ("data", "model")
    survivors: tuple = ()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape, strict=True))

    def build(self, device_type: str = "cuda"):
        """The grid's DeviceMesh in the world the survivors re-formed:
        survivor k of the old world is rank k of this one."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if dist.get_world_size() != len(self.survivors):
            raise ValueError(f"the world has {dist.get_world_size()} ranks, "
                             f"the grid {len(self.survivors)} survivors")
        new = {old: k for k, old in enumerate(self.survivors)}
        ranks = np.vectorize(new.__getitem__)(self.ranks)
        return DeviceMesh(device_type, torch.as_tensor(ranks),
                          mesh_dim_names=self.axis_names)


def shrink_mesh(failed: "set[int] | int", *, model_axis: int | None = None,
                ranks=None) -> Grid:
    """Largest usable (data, model) grid over the surviving ranks (`ranks`,
    by default those of the initialised world); `failed` holds positions
    in `ranks`, an int n the first n."""
    if ranks is None:
        import torch.distributed as dist

        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if isinstance(failed, int):
        failed = set(range(failed))
    alive = [r for i, r in enumerate(ranks) if i not in failed]
    n = len(alive)
    if n < 1:
        raise ValueError("no ranks survive")
    model = model_axis or 1
    while model > 1 and n % model:
        model //= 2
    data = n // model
    grid = np.asarray(alive[: data * model]).reshape(data, model)
    return Grid(grid, ("data", "model"), tuple(alive))


def reshard_tree(tree: dict, axes_tree: dict, mesh,
                 rules: RuleSet | None = None) -> dict:
    """Place each full leaf of `tree` (e.g. a restored checkpoint's, on
    the host) on `mesh` (a DeviceMesh) by its logical axes: the leaf on
    the mesh's device type, then `distribute_tensor` with the placements
    of `spec_for`.  Returns DTensors keyed alike."""
    from torch.distributed.tensor import distribute_tensor

    specs = tree_specs(axes_tree, tree, mesh, rules)

    def put(leaf, spec):
        if isinstance(leaf, dict):
            return {k: put(v, spec[k]) for k, v in leaf.items()}
        return distribute_tensor(leaf.to(mesh.device_type), mesh,
                                 placements(spec, mesh))

    return put(tree, specs)
