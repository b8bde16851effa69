"""Port of ``cuking_tpu/ops/king_pallas.py``: the KING count kernel's two
entries, over the hand-written CUDA kernel in ``csrc/king_counts.cu``.

* :func:`panel_counts_cuda` — the sliced entry (cf. ``panel_counts_pallas``):
  every row of ``planes_i`` against every row of ``planes_j``.
* :func:`panel_counts_cuda_indexed` — the indexed entry (cf.
  ``panel_counts_pallas_indexed``), the engine's default: rows
  ``[i_off, i_off + panel) x [j_off, j_off + panel_j)`` read in place from
  the full storage, with an optional separate ``planes_j``.  Any row offset
  is legal (the TPU's tile-multiple rule came from BlockSpec indexing).

Planes are int32 views of the uint32 words, ``[2, rows, W]``.  Each entry
returns six ``[NI, NJ]`` int32 counters.  With ``tri`` set (a diagonal panel
pair), counter tiles wholly below the diagonal are left unwritten: callers
mask with the strict global ``i < j`` predicate (cuking.cu:199).

A CPU tensor takes the plain version (``king_mm.panel_counts_matmul``).  A
CUDA tensor launches the kernel or raises; nothing falls back.  The kernel is
built with ``nvcc`` at first use, from the sources in this package, into
``_build/`` (rebuilt when the source is newer than the library), and bound
through a plain C interface with ctypes.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import os
import threading

import torch

from cuking_tpu_torch.ops.king_math import KingCounts
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.utils.status import (
    FailedPreconditionError,
    InvalidArgumentError,
    UnknownError,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "king_counts.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libking_counts.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

_lock = threading.Lock()
_lib = None


def _compile_if_stale() -> str:
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE):
        return ""
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build under a private name and rename into place, so a concurrent
    # process never loads a half-written library.
    tmp = f"{LIB_PATH}.tmp-{os.getpid()}"
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True
        )
    except FileNotFoundError as e:
        raise FailedPreconditionError(f"nvcc not found: {e}")
    if proc.returncode:
        raise FailedPreconditionError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return proc.stderr


def build() -> str:
    """Compiles the kernel library if it is missing or older than its
    source, and loads it.  Returns the compiler's report (``ptxas -v``), or
    '' when the library was current."""
    global _lib
    with _lock:
        report = _compile_if_stale()
        if _lib is None:
            import ctypes

            lib = ctypes.CDLL(LIB_PATH)
            p, i64 = ctypes.c_void_p, ctypes.c_longlong
            lib.king_counts_launch.restype = ctypes.c_int
            lib.king_counts_launch.argtypes = [
                p, i64, i64, i64,  # planes_i, rows_i, i_off, ni
                p, i64, i64, i64,  # planes_j, rows_j, j_off, nj
                i64, ctypes.c_int, p, p,  # words, tri, out, stream
            ]
            _lib = lib
    return report


def _check(planes: torch.Tensor, off: int, n: int, name: str) -> None:
    if planes.dim() != 3 or planes.shape[0] != 2:
        raise InvalidArgumentError(
            f"{name} must be [2, rows, W]; got {tuple(planes.shape)}"
        )
    if planes.dtype != torch.int32:
        raise InvalidArgumentError(
            f"{name} must be an int32 view of the uint32 planes; got {planes.dtype}"
        )
    if not planes.is_contiguous():
        raise InvalidArgumentError(f"{name} must be contiguous")
    if off < 0 or n <= 0 or off + n > planes.shape[1]:
        raise InvalidArgumentError(
            f"{name}: rows [{off}, {off + n}) are out of bounds for "
            f"{planes.shape[1]} rows"
        )


def _panel_counts(planes_i, i_off, ni, planes_j, j_off, nj, tri) -> KingCounts:
    i_off, ni, j_off, nj = int(i_off), int(ni), int(j_off), int(nj)
    _check(planes_i, i_off, ni, "planes_i")
    _check(planes_j, j_off, nj, "planes_j")
    if planes_i.shape[2] != planes_j.shape[2]:
        raise InvalidArgumentError(
            f"planes_i has W={planes_i.shape[2]}, planes_j W={planes_j.shape[2]}"
        )
    if planes_i.device != planes_j.device:
        raise InvalidArgumentError(
            f"planes on different devices: {planes_i.device}, {planes_j.device}"
        )
    if planes_i.device.type == "cpu":
        return panel_counts_matmul(
            planes_i[:, i_off : i_off + ni], planes_j[:, j_off : j_off + nj]
        )
    if planes_i.device.type != "cuda":
        raise InvalidArgumentError(
            f"the count kernel runs on CUDA (or its plain version on the "
            f"CPU); got device {planes_i.device}"
        )
    return _launch(planes_i, i_off, ni, planes_j, j_off, nj, tri)


def _launch(planes_i, i_off, ni, planes_j, j_off, nj, tri) -> KingCounts:
    global launches
    words = planes_i.shape[2]
    if words % 4:
        raise InvalidArgumentError(
            f"the CUDA count kernel reads rows as 16-byte words; W={words} "
            "is not a multiple of 4 (PlaneLayout's default multiple is)"
        )
    for name, p in (("planes_i", planes_i), ("planes_j", planes_j)):
        if p.data_ptr() % 16:
            raise InvalidArgumentError(f"{name} is not 16-byte aligned")
    if _lib is None:
        build()
    out = torch.empty((6, ni, nj), dtype=torch.int32, device=planes_i.device)
    stream = torch.cuda.current_stream(planes_i.device).cuda_stream
    with torch.cuda.device(planes_i.device):
        err = _lib.king_counts_launch(
            planes_i.data_ptr(), planes_i.shape[1], i_off, ni,
            planes_j.data_ptr(), planes_j.shape[1], j_off, nj,
            words, 1 if tri else 0, out.data_ptr(), stream,
        )
    if err:
        raise UnknownError(f"king_counts kernel launch failed: CUDA error {err}")
    launches += 1
    return KingCounts(*out.unbind(0))


def panel_counts_cuda(
    planes_i: torch.Tensor, planes_j: torch.Tensor, tri=0
) -> KingCounts:
    """Sliced entry: six [NI, NJ] counters of every row of ``planes_i``
    ([2, NI, W]) against every row of ``planes_j`` ([2, NJ, W])."""
    return _panel_counts(
        planes_i, 0, planes_i.shape[1], planes_j, 0, planes_j.shape[1], tri
    )


def panel_counts_cuda_indexed(
    planes: torch.Tensor,
    i_off: int,
    j_off: int,
    tri,
    panel: int,
    planes_j: torch.Tensor | None = None,
    panel_j: int | None = None,
) -> KingCounts:
    """Indexed entry: six [panel, panel_j] counters for rows
    ``[i_off, i_off + panel)`` of ``planes`` against rows
    ``[j_off, j_off + panel_j)`` of ``planes_j`` (default: ``planes``).
    Raises InvalidArgumentError when a range runs past its storage."""
    planes_j = planes if planes_j is None else planes_j
    panel_j = panel if panel_j is None else panel_j
    return _panel_counts(planes, i_off, panel, planes_j, j_off, panel_j, tri)
