"""Divisibility-aware sharding helpers (the JAX package's
`distributed/sharding.py`).

A tensor dim is sharded over a mesh axis (or a tuple of axes) only when its
size divides; otherwise that dim is replicated. A spec is a tuple with one
entry per dim: None (replicated), an axis name, or a tuple of axis names
(the dim split over their product, major first), as a JAX PartitionSpec
reads. `placements` turns a spec into DTensor placements, one per mesh dim.

The rules need only a mesh's names and sizes (`launch/mesh.Mesh`), so they
evaluate without devices. `constraint` (the reference's
`with_sharding_constraint`) has no counterpart on a mesh of more than one
device: the port runs one replica a card, and its step reshards nothing.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

from repro_torch.training import tree as tree_lib

AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]


def axis_size(mesh, axis: AxisName) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis]
    n = 1
    for a in axis:
        n *= mesh.shape[a]
    return n


def shardable(mesh, dim: int, axis: AxisName) -> AxisName:
    """`axis` if `dim` divides over it, else the longest prefix of a tuple
    axis that divides it, else None (replicate)."""
    if axis is None:
        return None
    n = axis_size(mesh, axis)
    if n > 0 and dim % n == 0 and dim >= n:
        return axis
    if isinstance(axis, tuple):
        for k in range(len(axis) - 1, 0, -1):
            sub = axis[:k]
            if dim % axis_size(mesh, sub) == 0 and dim >= axis_size(mesh, sub):
                return sub
    return None


def _canonical(axis: AxisName) -> AxisName:
    """A one-name tuple as the name itself (as PartitionSpec reads it)."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def pspec(mesh, shape: Sequence[int], axes: Sequence[AxisName]) -> Spec:
    """One entry a dim, dropping axes that do not divide their dims."""
    assert len(shape) == len(axes), (shape, axes)
    return tuple(_canonical(shardable(mesh, d, a))
                 for d, a in zip(shape, axes))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes of the batch dimension ('pod' + 'data' where present)."""
    names = mesh.axis_names
    out = tuple(a for a in ("pod", "data") if a in names)
    return out or (names[0],)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def constraint(x, mesh, axes: Sequence[AxisName]):
    """The identity on a mesh whose axes are all 1. Any other mesh raises:
    the port has no resharding inside a step (the reference's
    `with_sharding_constraint` is XLA's)."""
    if all(s == 1 for s in mesh.axis_sizes):
        return x
    raise NotImplementedError(
        f"a sharding constraint on mesh {mesh.shape} needs tensor "
        f"parallelism inside the step, which the port does not run")


def tree_shardings(mesh, tree, spec_fn: Callable):
    """spec_fn(path, leaf) -> Spec mapped over a tree of dicts and lists
    (paths as `training.tree.leaves_with_path` gives them)."""
    flat = tree_lib.leaves_with_path(tree)
    return tree_lib.unflatten(tree, [spec_fn(p, leaf) for p, leaf in flat])


def _mesh_dims(axis: AxisName) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def placements(mesh, spec: Spec):
    """DTensor placements of `spec` on `mesh`, one per mesh dim: Shard(d)
    on each mesh dim that tensor dim d is split over (a tuple axis gives
    Shard(d) on each of its mesh dims, which DTensor applies major first,
    in mesh order), Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for d, axis in enumerate(spec):
        names = _mesh_dims(axis)
        order = [mesh.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"axes {names} of dim {d} are not in the mesh's "
                             f"order {mesh.axis_names}")
        for i in order:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {mesh.axis_names[i]} shards two "
                                 f"dims of {spec}")
            out[i] = Shard(d)
    return out

