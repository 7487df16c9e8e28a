"""Meshes for the sharding rules, and the DeviceMesh over real cards.

The JAX package builds `jax.make_mesh` meshes over placeholder or real
devices. Its sharding rules read only a mesh's axis names and sizes, so
the port's `Mesh` is those two tuples: the rules (`distributed/sharding.py`,
`launch/shardings.py`) and the dry-run evaluate on it without any device.
`device_mesh` turns it into a `torch.distributed` DeviceMesh, and only
where a process group of that many ranks exists: it never stands in for
one device quietly.

The named meshes of the dry-run: `h100x1` (one card, 1 x 1), `h100x4`
(four data-parallel replicas, PICE's edge fleet on four cards),
`pod16x16` and `pod2x16x16` (the reference's production meshes, logical
shapes for the rules only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, major first (the reference mesh's `.shape` and
    `.axis_names`)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2x16x16 =
    512 chips (pod, data, model). Logical: the port runs on no pod."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh() -> Mesh:
    """A 1x1 mesh: the one card."""
    return Mesh(("data", "model"), (1, 1))


def make_edge_mesh(n_devices: int = 1) -> Mesh:
    """Edge fleet: pure data-parallel SLM replicas (PICE's p-way semantic
    parallelism maps onto the data axis)."""
    return Mesh(("data", "model"), (n_devices, 1))


MESHES = {
    "h100x1": make_local_mesh,
    "h100x4": lambda: make_edge_mesh(4),
    "pod16x16": make_production_mesh,
    "pod2x16x16": lambda: make_production_mesh(multi_pod=True),
}


def named_mesh(name: str) -> Mesh:
    if name not in MESHES:
        raise KeyError(f"unknown mesh {name!r}; known: {sorted(MESHES)}")
    return MESHES[name]()


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The `torch.distributed` DeviceMesh of `mesh`, with its axis names.
    Raises unless a process group of exactly `mesh.size` ranks is
    initialised (give `init_process_group` its address, world size and rank
    yourself: nothing on a card's machine announces a cluster)."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {mesh.axis_sizes} mesh needs a process group of "
            f"{mesh.size} ranks: call torch.distributed.init_process_group "
            f"first")
    world = dist.get_world_size()
    if world != mesh.size:
        raise RuntimeError(f"the process group has {world} ranks, the mesh "
                           f"{mesh.axis_sizes} needs {mesh.size}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)
