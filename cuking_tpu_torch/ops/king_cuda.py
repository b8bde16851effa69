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

A CPU tensor takes the plain version, :func:`panel_counts_five_block`: the
same five int8 products as the kernel, through ``torch._int_mm``.  A CUDA
tensor launches the kernel or raises; nothing falls back.  The kernels are
built with ``nvcc`` at first use, from the sources in ``csrc/``, into one
library in ``_build/``, and bound through a plain C interface with ctypes;
the library also holds the emit kernel (``csrc/king_emit.cu``), which
``ops/king_emit.py`` launches.  The library
is current while the SHA-256 of ``csrc/`` and the nvcc flags, stored beside
it at build time, still matches: a digest and not a modification time, so
that a library prebuilt into a container image stays current after ``COPY``
gives the sources newer times (the runtime image has no ``nvcc``).  ``launches``
counts launches of the wgmma kernel.

:func:`panel_counts_popc_indexed` runs the same contract through the first
port's AND + popcount kernel, the yardstick the wgmma kernel is timed
against.  Nothing on the main path calls it; ``popc_launches`` counts its
launches.
"""

from __future__ import annotations

import hashlib
import os
import threading

import torch

from cuking_tpu_torch.ops.king_math import KingCounts
from cuking_tpu_torch.ops.king_mm import pad_rows, unpack_plane
from cuking_tpu_torch.utils.status import (
    FailedPreconditionError,
    InvalidArgumentError,
    UnknownError,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = (os.path.join(CSRC, "king_counts.cu"), os.path.join(CSRC, "king_emit.cu"))
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libking_counts.so")
DIGEST_PATH = os.path.join(BUILD_DIR, "libking_counts.sha256")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# C entries of the library.  The two count entries share
# king_counts_launch's signature.
ENTRY = "king_counts_launch"            # the wgmma kernel: the main path
POPC_ENTRY = "king_counts_popc_launch"  # the AND + popcount yardstick
EMIT_ENTRY = "king_emit_launch"         # the emit kernel (ops/king_emit.py)

# Kernel launches since import (or since a caller reset them to 0).
launches = 0       # the wgmma kernel
popc_launches = 0  # the AND + popcount yardstick

_lock = threading.Lock()
_lib = None


def source_digest() -> str:
    """SHA-256 over every file under ``csrc/`` (relative path and bytes, in
    sorted order) and the nvcc flags: what the library was built from."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for root, dirs, files in os.walk(CSRC):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, CSRC).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def library_is_current() -> bool:
    """True when the library exists and was built from the sources and
    flags it would be built from now."""
    try:
        with open(DIGEST_PATH) as f:
            built_from = f.read().strip()
    except FileNotFoundError:
        return False
    return os.path.exists(LIB_PATH) and built_from == source_digest()


def _compile_if_stale() -> str:
    if library_is_current():
        return ""
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    digest = source_digest()
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build under a private name and rename into place, so a concurrent
    # process never loads a half-written library.
    tmp = f"{LIB_PATH}.tmp-{os.getpid()}"
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *SOURCES], capture_output=True, text=True
        )
    except FileNotFoundError as e:
        raise FailedPreconditionError(f"nvcc not found: {e}")
    if proc.returncode:
        raise FailedPreconditionError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    # The digest goes in after the library, so a reader that sees it current
    # finds the new library in place.
    with open(tmp, "w") as f:
        f.write(digest + "\n")
    os.replace(tmp, DIGEST_PATH)
    return proc.stderr


def build() -> str:
    """Compiles the kernel library if it is missing or was built from other
    sources or flags (:func:`library_is_current`), and loads it.  Returns the compiler's report
    (``ptxas -v``), or '' when the library was current."""
    global _lib
    with _lock:
        report = _compile_if_stale()
        if _lib is None:
            import ctypes

            lib = ctypes.CDLL(LIB_PATH)
            p, i64 = ctypes.c_void_p, ctypes.c_longlong
            for name in (ENTRY, POPC_ENTRY):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    p, i64, i64, i64,  # planes_i, rows_i, i_off, ni
                    p, i64, i64, i64,  # planes_j, rows_j, j_off, nj
                    i64, ctypes.c_int, p, p,  # words, tri, out, stream
                ]
            emit = getattr(lib, EMIT_ENTRY)
            emit.restype = ctypes.c_int
            emit.argtypes = [
                p, i64, i64,       # counts, ni, nj
                i64, i64, i64, i64,  # gi_base, gj_base, i_limit, j_limit
                ctypes.c_float, ctypes.c_int, ctypes.c_int,  # threshold, strict, sym
                p, i64, p, p,      # out, capacity, count, stream
            ]
            _lib = lib
    return report


def library():
    """The loaded kernel library, built first if this process has not
    loaded it yet."""
    if _lib is None:
        build()
    return _lib


def five_block_indicators(planes: torch.Tensor):
    """[2, N, W] packed → int8 [N, 32·W] H (het), v (hom-ref or hom-alt) and
    u (+1 hom-alt, −1 hom-ref); missing sites are 0 in all three."""
    het, hom = planes[0], planes[1]
    a = unpack_plane(~het & hom)
    r = unpack_plane(~het & ~hom)
    return unpack_plane(het & ~hom), a + r, a - r


def panel_counts_five_block(
    planes_i: torch.Tensor,
    planes_j: torch.Tensor,
    site_chunk_words: int = 128,
) -> KingCounts:
    """The kernel's plain version: six KING counters from five int8 products.

    planes_i: [2, NI, W] int32, planes_j: [2, NJ, W] int32 → six [NI, NJ]
    int32.  One ``torch._int_mm`` of the stacked ``[H; v]`` indicators gives
    HH, Hv, vH and vv, and a second gives uu (XY := X_i · Y_jᵀ over sites):

        both_het = HH        het_i = HH + Hv        het_j = HH + vH
        shared_sites = HH + Hv + vH + vv
        opposing_hom = (vv − uu) / 2     concordant_hom = (vv + uu) / 2

    The site axis runs in chunks of ``site_chunk_words`` (the last may be
    shorter), as in ``king_mm.panel_counts_matmul``.  It computes every pair:
    unlike the kernel it has no diagonal-tile skip.
    """
    ni, nj = planes_i.shape[1], planes_j.shape[1]
    w = planes_i.shape[2]
    hv = uu = None
    for lo in range(0, w, site_chunk_words):
        hi = min(lo + site_chunk_words, w)
        h_i, v_i, u_i = five_block_indicators(planes_i[:, :, lo:hi])
        h_j, v_j, u_j = five_block_indicators(planes_j[:, :, lo:hi])
        part = torch._int_mm(pad_rows(torch.cat([h_i, v_i])),
                             pad_rows(torch.cat([h_j, v_j])).t())
        part_u = torch._int_mm(pad_rows(u_i), pad_rows(u_j).t())
        hv = part if hv is None else hv.add_(part)
        uu = part_u if uu is None else uu.add_(part_u)
    hh, h_v = hv[:ni, :nj], hv[:ni, nj : 2 * nj]
    v_h, vv = hv[ni : 2 * ni, :nj], hv[ni : 2 * ni, nj : 2 * nj]
    vv64, uu64 = vv.long(), uu[:ni, :nj].long()
    return KingCounts(
        both_het=hh,
        het_i=hh + h_v,
        het_j=hh + v_h,
        opposing_hom=((vv64 - uu64) // 2).int(),
        concordant_hom=((vv64 + uu64) // 2).int(),
        shared_sites=hh + h_v + v_h + vv,
    )


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


def _check_pair(planes_i, i_off, ni, planes_j, j_off, nj) -> None:
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


def _panel_counts(planes_i, i_off, ni, planes_j, j_off, nj, tri) -> KingCounts:
    global launches
    i_off, ni, j_off, nj = int(i_off), int(ni), int(j_off), int(nj)
    _check_pair(planes_i, i_off, ni, planes_j, j_off, nj)
    if planes_i.device.type == "cpu":
        return panel_counts_five_block(
            planes_i[:, i_off : i_off + ni], planes_j[:, j_off : j_off + nj]
        )
    if planes_i.device.type != "cuda":
        raise InvalidArgumentError(
            f"the count kernel runs on CUDA (or its plain version on the "
            f"CPU); got device {planes_i.device}"
        )
    counts = _launch(ENTRY, planes_i, i_off, ni, planes_j, j_off, nj, tri)
    launches += 1
    return counts


def _launch(entry, planes_i, i_off, ni, planes_j, j_off, nj, tri) -> KingCounts:
    """Launches the library's C entry ``entry`` on checked CUDA planes."""
    words = planes_i.shape[2]
    if words % 4:
        raise InvalidArgumentError(
            f"the CUDA count kernel reads rows as 16-byte words; W={words} "
            "is not a multiple of 4 (PlaneLayout's default multiple is)"
        )
    for name, p in (("planes_i", planes_i), ("planes_j", planes_j)):
        if p.data_ptr() % 16:
            raise InvalidArgumentError(f"{name} is not 16-byte aligned")
    lib = library()
    out = torch.empty((6, ni, nj), dtype=torch.int32, device=planes_i.device)
    stream = torch.cuda.current_stream(planes_i.device).cuda_stream
    with torch.cuda.device(planes_i.device):
        err = getattr(lib, entry)(
            planes_i.data_ptr(), planes_i.shape[1], i_off, ni,
            planes_j.data_ptr(), planes_j.shape[1], j_off, nj,
            words, 1 if tri else 0, out.data_ptr(), stream,
        )
    if err:
        raise UnknownError(f"{entry} failed: CUDA error {err}")
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


def panel_counts_popc_indexed(
    planes: torch.Tensor,
    i_off: int,
    j_off: int,
    tri,
    panel: int,
    planes_j: torch.Tensor | None = None,
    panel_j: int | None = None,
) -> KingCounts:
    """:func:`panel_counts_cuda_indexed` through the AND + popcount kernel:
    the yardstick, off the main path.  CUDA tensors only: it exists to be
    timed against the wgmma kernel on the card."""
    global popc_launches
    planes_j = planes if planes_j is None else planes_j
    panel_j = panel if panel_j is None else panel_j
    i_off, panel, j_off, panel_j = int(i_off), int(panel), int(j_off), int(panel_j)
    _check_pair(planes, i_off, panel, planes_j, j_off, panel_j)
    if planes.device.type != "cuda":
        raise InvalidArgumentError(
            f"the AND + popcount yardstick runs on CUDA only; got device {planes.device}"
        )
    counts = _launch(POPC_ENTRY, planes, i_off, panel, planes_j, j_off, panel_j, tri)
    popc_launches += 1
    return counts
