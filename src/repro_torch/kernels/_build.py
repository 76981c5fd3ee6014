"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one process
per source, all started together), linked into one shared library with a
plain C interface under ``build/repro_torch_kernels/`` at the repository
root, and loaded with ``ctypes``. The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is built at import: the first kernel launch (or
an explicit :func:`library` call) builds. The library links against the
CUDA runtime alone: the tensor-core kernels get ``cuTensorMapEncodeTiled``
(their TMA descriptors) from the driver through ``cudaGetDriverEntryPoint``,
so no ``-lcuda`` is needed.

There is no fallback: without ``nvcc`` or a card, or when a build fails,
:func:`library` raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Storage-format codes shared with csrc/common.cuh (enum DType).
DTYPE_CODE = {
    torch.float32: 0,
    torch.float16: 1,
    torch.bfloat16: 2,
    torch.float8_e4m3fn: 3,
    torch.float8_e5m2: 4,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

_SIGNATURES = {
    "redmule_gemm_launch": [_I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _I,
                            _I, _I, _I, _I, _I] + [_L] * 12 + [_P],
    "redmule_gemm_tc_launch": [_I, _I, _P, _P, _P, _I, _P, _I,
                               _I, _I, _I, _I, _I] + [_L] * 10 + [_P],
    "redmule_gemm_sr_launch": [_I, _I, _P, _P, _P, _I, _P, _I, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I] + [_L] * 11 + [_P],
    "redmule_splitk_combine_launch": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I]
                                     + [_L] * 4 + [_P],
    "kmajor_copy_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I] + [_L] * 4 + [_P],
    "paged_decode_launch": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "flash_attention_tc_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the port's kernels are built on a host with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_source_hash()}.so"
    build_log = ""
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        objs = [BUILD_DIR / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        t0 = time.perf_counter()
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            build_log += f"== {src.name} (done at {time.perf_counter() - t0:.1f} s)\n{out}"
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n{link.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.build_log = build_log
    return lib


class LaunchCount:
    """Launches of one kernel: its wrapper adds one where it launches and
    nowhere else, so a run can show that its main path went through it."""

    def __init__(self) -> None:
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def check_launch(err: int, name: str) -> None:
    """Raise when a kernel's C launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"the kernels take {list(DTYPE_CODE)}, not {t.dtype}") from None
