"""Port of ``cuking_tpu/native/packer.py``: the same ``native/packer.cpp``,
built into its own library file (``libcuking_packer_torch.so``), written to a
temporary name and renamed into place so that processes building at once
never load a half-written library.  Its default thread count follows the
CPUs this process may run on (:func:`usable_cpus`, the affinity mask that
``taskset`` or a container's cpuset sets), where the JAX package's copy
counts every core of the host.

ctypes binding + on-demand build for the native C++ packer.

Builds ``native/packer.cpp`` into a shared library with g++ (cached under
``native/build/``), exposing :func:`clear_bits` with the same contract as
``bitset.clear_bits_coo`` but lock-free (relaxed atomic AND per word, like the
reference's AtomicClearBit, cuking.cu:316-323) so ingest threads never
serialize on a Python lock.  Falls back gracefully: ``available()`` is False
when no compiler is present, and callers use the numpy path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.utils.status import FailedPreconditionError

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "packer.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libcuking_packer_torch.so")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.tmp-{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++20", "-shared", "-fPIC",
        "-pthread", _SRC, "-o", tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH) or os.path.getmtime(
                _LIB_PATH
            ) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            if lib.cuking_packer_abi_version() != _ABI_VERSION:
                _build()
                lib = ctypes.CDLL(_LIB_PATH)
            lib.cuking_clear_bits.restype = ctypes.c_longlong
            lib.cuking_clear_bits.argtypes = [
                ctypes.c_void_p,  # het plane
                ctypes.c_void_p,  # hom plane
                ctypes.c_longlong,  # plane words
                ctypes.c_void_p,  # lin_word int64
                ctypes.c_void_p,  # bit uint32
                ctypes.c_void_p,  # n_alt int32
                ctypes.c_longlong,  # n
                ctypes.c_int,  # num_threads
            ]
            _lib = lib
        except Exception:
            _load_failed = True
            _lib = None
        return _lib


def usable_cpus() -> int:
    """The CPUs this process may run on: its affinity mask, which ``taskset``
    and a container's cpuset narrow, not ``os.cpu_count()``, which counts
    every core of the host."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity masks on this platform
        return os.cpu_count() or 1


def available() -> bool:
    return _load() is not None


def clear_bits(
    planes: np.ndarray,
    layout: PlaneLayout,
    sample_offsets: np.ndarray,
    site_indices: np.ndarray,
    n_alt_alleles: np.ndarray,
    *,
    source: str = "<input>",
    num_threads: int = 0,
) -> None:
    """Lock-free scatter of COO entries into the planes; see
    bitset.clear_bits_coo for semantics."""
    lib = _load()
    if lib is None:
        raise FailedPreconditionError("native packer not available")
    n = len(n_alt_alleles)
    if n == 0:
        return
    assert planes.dtype == np.uint32 and planes.flags.c_contiguous

    sites = np.ascontiguousarray(site_indices, dtype=np.int64)
    if sites.size and (sites.min() < 0 or sites.max() >= layout.num_sites):
        raise FailedPreconditionError(
            f"Site index out of range [0, {layout.num_sites}) in {source}"
        )
    offs = np.ascontiguousarray(sample_offsets, dtype=np.int64)
    lin = offs * layout.words + (sites % layout.words)
    bit = np.ascontiguousarray(sites // layout.words, dtype=np.uint32)
    nalt = np.ascontiguousarray(n_alt_alleles, dtype=np.int32)

    plane_words = planes.shape[1] * planes.shape[2]
    if num_threads <= 0:
        num_threads = min(usable_cpus(), 16)
    bad = lib.cuking_clear_bits(
        planes[0].ctypes.data,
        planes[1].ctypes.data,
        plane_words,
        lin.ctypes.data,
        bit.ctypes.data,
        nalt.ctypes.data,
        n,
        num_threads,
    )
    if bad >= 0:
        raise FailedPreconditionError(
            f"Invalid value for n_alt_alleles ({int(nalt[bad])}) "
            f"encountered in {source}"
        )
