"""Checkpoints of the port's training state: atomic, keep-k, async
(counterpart of ``repro.checkpoint.manager``).

Layout: <dir>/step_<N>/
  - arrays.npz   the tree's leaves in order (bf16 and fp8 tensors stored as
                 same-width unsigned-integer views, so numpy needs no
                 extension types)
  - meta.json    step, number of leaves, each leaf's format, extra metadata
  - _COMPLETE    commit marker written last: readers ignore a directory
                 without it, so a process dying mid-write never corrupts a
                 restore

A restore fills the structure of a template tree (``like``), placing each
tensor on the template's device, in the template's format and layout (a
K-major weight stays K-major). Python ints (the step and skip counters)
round-trip as such.

Sharded state (``shardings=``, a tree of
``distrib.sharding.NamedSharding`` matching the tree, None where a leaf is
whole): :func:`save` gathers each leaf to its full shape on every rank of
the mesh (a collective: every rank calls it) and rank 0 writes it, in the
single-process format; :func:`restore` reads the full leaf and keeps the
rank's piece. So a checkpoint saved at one world size restores at another
(the elastic scale-down of ``distrib/fault.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import leaves, unflatten
from repro_torch.distrib import sharding as shd

_BIT_VIEWS = {
    torch.bfloat16: (torch.int16, np.uint16),
    torch.float8_e4m3fn: (torch.uint8, np.uint8),
    torch.float8_e5m2: (torch.uint8, np.uint8),
}
_TORCH_DTYPES = {str(dt).removeprefix("torch."): dt for dt in (
    torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)}


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array and the name of its format."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), "int" if isinstance(leaf, int) else "float"
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _BIT_VIEWS:
        view, np_bits = _BIT_VIEWS[t.dtype]
        return t.view(view).numpy().view(np_bits), name
    return t.numpy(), name


def _host_tree(tree, shardings=None) -> list:
    flat = leaves(tree)
    if shardings is None:
        return [_to_host(leaf) for leaf in flat]
    shs = shd.spec_leaves(shardings)
    if len(shs) != len(flat):
        raise ValueError(f"{len(shs)} shardings for {len(flat)} leaves")
    return [_to_host(leaf if sh is None else shd.gather_full(leaf, sh.spec, sh.mesh))
            for leaf, sh in zip(flat, shs)]


def _writes(shardings) -> bool:
    """Whether this process writes: rank 0 of a sharded save, any process
    of a whole one."""
    shs = [sh for sh in shd.spec_leaves(shardings) if sh is not None] if shardings else []
    return not shs or shs[0].mesh.rank == 0


def _write(directory: str, step: int, host: list, extra: dict | None, keep: int) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(host), "dtypes": [d for _, d in host],
                   "extra": extra or {}}, f)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _gc(directory, keep)
    return path


def save(directory: str, step: int, tree: Any, *, extra: dict | None = None,
         keep: int = 3, shardings: Any = None) -> str:
    """Synchronous atomic save of ``tree`` as step ``step`` (gathered first
    under ``shardings``; rank 0 writes). Returns its path."""
    host = _host_tree(tree, shardings)
    if not _writes(shardings):
        return os.path.join(directory, f"step_{step:08d}")
    return _write(directory, step, host, extra, keep)


class AsyncSaver:
    """Overlap checkpoint writes with training (one in flight). The copy to
    the host happens in :meth:`save`, before it returns, so the caller may
    go on with the next step; the file writes run in a thread."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, directory: str, step: int, tree: Any, *, extra: dict | None = None,
             keep: int = 3, shardings: Any = None) -> None:
        self.wait()
        host = _host_tree(tree, shardings)
        if not _writes(shardings):
            return

        def run():
            try:
                _write(directory, step, host, extra, keep)
            except Exception as e:  # re-raised by wait() in the caller's thread
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the write in flight; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "_COMPLETE"))]
    return max(steps, default=None)


def _from_host(arr: np.ndarray, name: str, like, sh=None):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item())
    dtype = _TORCH_DTYPES[name]
    if dtype in _BIT_VIEWS:
        t = torch.from_numpy(arr.copy()).view(_BIT_VIEWS[dtype][0]).view(dtype)
    else:
        t = torch.from_numpy(arr.copy())
    if sh is not None:
        t = sh.shard(t)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch: checkpoint {tuple(t.shape)} vs target {tuple(like.shape)}")
    out = torch.empty_like(like, dtype=like.dtype)  # the template's layout
    return out.copy_(t.to(like.dtype))


def restore(directory: str, step: int, like: Any, *, shardings: Any = None) -> Any:
    """The checkpoint of ``step``, in the structure, devices, formats and
    layouts of ``like``; with ``shardings``, each leaf's piece for this rank
    (``like`` holds the pieces)."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"incomplete or missing checkpoint: {path}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    template = leaves(like)
    if meta["n_leaves"] != len(template):
        raise ValueError(f"checkpoint/tree structure mismatch: checkpoint has "
                         f"{meta['n_leaves']} leaves, target tree has {len(template)}")
    shs = shd.spec_leaves(shardings) if shardings is not None else [None] * len(template)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = [_from_host(data[f"leaf_{i}"], meta["dtypes"][i], ref, sh)
                for i, (ref, sh) in enumerate(zip(template, shs))]
    return unflatten(like, flat)


def restore_latest(directory: str, like: Any, *, shardings: Any = None):
    """(step, tree) of the newest complete checkpoint, or (None, None)."""
    step = latest_step(directory)
    if step is None:
        return None, None
    return step, restore(directory, step, like, shardings=shardings)
