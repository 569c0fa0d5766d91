"""Device meshes of the port (port of `repro.launch.mesh`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the initialised process group, one rank a device.  Building one touches
the world only when a function is called, never at import.

Target hardware: NVIDIA H100 80GB HBM3 (SXM, 700 W), NVIDIA's H100 data
sheet, dense rates without sparsity.  The production meshes keep the
reference's chip counts (256 and 512: 16 x 16 and 2 x 16 x 16 TPU v5e
chips) and put the "model" axis inside one 8-card H100 node, so that
tensor parallelism stays on NVLink: (32, 8) ("data", "model") and
(2, 32, 8) ("pod", "data", "model").
"""

from __future__ import annotations

import math

from ..device import resolve_device

PEAK_FLOPS = 989e12        # bf16 dense, per card (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s per card (H100 SXM HBM3)
HBM_BYTES = 80 * 10**9     # per card (H100 80GB)
NVLINK_BW = 450e9          # bytes/s per card and direction (900 GB/s NVLink
                           # 4 total, H100 SXM data sheet)


PRODUCTION_MESHES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (32, 8) ("data", "model") mesh of 256 cards, or with
    `multi_pod` the (2, 32, 8) ("pod", "data", "model") mesh of 512,
    over the initialised world, which must hold exactly that many ranks
    (a real one, or torch's fake process group for a dry run on the
    CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    resolve_device(device_type)
    shape, axes = PRODUCTION_MESHES[multi_pod]
    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"the {shape} mesh needs a world of "
                         f"{math.prod(shape)} ranks, not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda"):
    """A (world // model, model) mesh named ("data", "model") over every
    rank of the initialised world, on the card ("cuda", the default) or
    the CPU ("cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    resolve_device(device_type)
    world = _world()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {world} ranks")
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} in the mesh's dim order: a DeviceMesh's named
    dims, or any mesh whose `.shape` is such a dict (the reference's
    duck-typed test meshes, `runtime.elastic.Grid`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        # sizes by `size(i)`: `mesh.mesh` builds a tensor, which a
        # FakeTensorMode (a dry run) refuses
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def mesh_chip_count(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())
