"""Meshes of the port (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is plain data: axis names, their sizes, and this process's
coordinates, ranks laid out row-major over the axes (the last axis
varies fastest), as ``jax.make_mesh`` lays out its devices. It is not a
``torch.distributed.DeviceMesh``, for two reasons: the production meshes
(16 x 16 and 2 x 16 x 16) must exist without 256 or 512 processes, for
the dry run, which only reads their shape; and a mesh of one process
must run with no process group at all.

When ``torch.distributed`` is initialised with a world size equal to the
mesh's size, :meth:`Mesh.group` makes the process group of an axis (or a
tuple of axes) on first use: one group for each combination of the other
axes' coordinates, every rank creating every group in the same order, as
``new_group`` requires. An axis of size one needs no group.
"""
from __future__ import annotations

import math
from typing import Iterable


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class Mesh:
    """Axis names, sizes and this process's coordinates on them."""

    def __init__(self, shape: Iterable[int], axis_names: Iterable[str], rank: int | None = None):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
        self.axis_names = names
        self.shape = dict(zip(names, shape))  # the reference's ``mesh.shape[axis]``
        self.size = math.prod(shape)
        if rank is None:
            rank = _dist_rank() if self._distributed() else 0
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} lies outside a mesh of {self.size}")
        self.rank = rank
        self._groups: dict[tuple, object] = {}

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}; rank {self.rank})"

    def coords_of(self, rank: int) -> dict:
        """The coordinates of ``rank``, row-major."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    @property
    def coords(self) -> dict:
        return self.coords_of(self.rank)

    def axis_size(self, axis) -> int:
        """The size of an axis, or the product over a tuple of axes."""
        return math.prod(self.shape[a] for a in _axes(axis))

    def axis_index(self, axis, rank: int | None = None) -> int:
        """This rank's (or ``rank``'s) index along an axis, or along a tuple
        of axes taken major to minor, as a ``NamedSharding`` over a tuple of
        axes numbers its pieces."""
        coords = self.coords if rank is None else self.coords_of(rank)
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def _distributed(self) -> bool:
        import torch.distributed as dist

        return (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() == self.size)

    def group_ranks(self, axis) -> list[int]:
        """The ranks that share every coordinate but ``axis`` with this rank,
        in their order along ``axis``."""
        axes = _axes(axis)
        members = [r for r in range(self.size)
                   if all(self.coords_of(r)[a] == self.coords[a]
                          for a in self.axis_names if a not in axes)]
        return sorted(members, key=lambda r: self.axis_index(axes, r))

    def group(self, axis):
        """The process group of ``axis`` (a name or a tuple of names), made
        on first use; None where the axis has size one. Raises when the axis
        spans several processes and no process group of the mesh's size is
        initialised (an abstract mesh, such as the dry run's)."""
        axes = _axes(axis)
        if self.axis_size(axes) == 1:
            return None
        if axes not in self._groups:
            if not self._distributed():
                raise RuntimeError(
                    f"{self!r}: axis {axes} spans {self.axis_size(axes)} processes, but no "
                    f"process group of {self.size} ranks is initialised")
            import torch.distributed as dist

            mine = None
            others = [a for a in self.axis_names if a not in axes]
            seen = set()
            for r in range(self.size):  # every group, in the same order on every rank
                key = tuple(self.coords_of(r)[a] for a in others)
                if key in seen:
                    continue
                seen.add(key)
                ranks = [q for q in range(self.size)
                         if tuple(self.coords_of(q)[a] for a in others) == key]
                ranks.sort(key=lambda q: self.axis_index(axes, q))
                if ranks != sorted(ranks):  # a group numbers its members by global rank
                    raise ValueError(f"axes {axes} are not in the mesh's order "
                                     f"{self.axis_names}")
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]


def _dist_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def make_mesh(shape, axes, rank: int | None = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``; this process's rank from
    ``torch.distributed`` when it is initialised at the mesh's size, else
    ``rank`` (default 0)."""
    return Mesh(shape, axes, rank)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod. Abstract: the
    dry run reads its shape and runs no collective on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, rank)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), rank: int | None = None) -> Mesh:
    """A small mesh for multi-process tests."""
    return Mesh(shape, axes, rank)


def dp_axes_of(mesh: Mesh) -> tuple:
    """Batch-sharding axes: every axis but 'model'."""
    return tuple(a for a in mesh.axis_names if a != "model")


def tp_size_of(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def n_dp_of(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes_of(mesh))
