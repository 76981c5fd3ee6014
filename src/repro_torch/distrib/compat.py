"""Axis queries of the port's explicit per-rank bodies (counterpart of
``repro.distrib.compat``).

The reference's module also carries ``set_mesh`` and ``shard_map``: shims
over JAX releases, which have no meaning in torch. The port replaces them
with :class:`repro_torch.launch.mesh.Mesh` and with bodies written per
rank (``models/moe.py::apply_ep``, the training step's reductions) that
call ``torch.distributed`` over the mesh's groups themselves.
"""
from __future__ import annotations


def axis_size(mesh, axis) -> int:
    """The number of ranks along ``axis`` (a name or a tuple of names);
    ``jax.lax.axis_size`` inside a ``shard_map`` body."""
    return 1 if mesh is None else mesh.axis_size(axis)


def axis_index(mesh, axis) -> int:
    """This rank's index along ``axis``; ``jax.lax.axis_index``."""
    return 0 if mesh is None else mesh.axis_index(axis)
