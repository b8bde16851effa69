"""Parquet ingest: the port (cuking_tpu_torch.io.parquet_ingest) gives the
same planes, byte for byte, as the JAX package's ingest, on the golden input
and on a synthetic one, for every shard of split factors 1 and 2, on the
native packer and on the numpy path; and the same error messages.

The reference is always the JAX package's numpy path.  Its native packer
(cuking_tpu/native/packer.py) is built in place under native/build/ by the
first process that needs it, and a process that loads it while another is
still writing it keeps it unavailable for good: under xdist that is a test
worker, where ``use_native=True`` would then fail in the JAX ingest and not
in the port.  tests/test_native_packer.py holds that packer to the numpy
path, and the port's native cases are held to the port's numpy path too."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from cuking_tpu.io.parquet_ingest import ingest_parquet as jax_ingest
from cuking_tpu.io.uri import Storage as JaxStorage
from cuking_tpu.models.king import PanelStorage as JaxPanelStorage
from cuking_tpu.ops.bitset import PlaneLayout as JaxPlaneLayout
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix
from cuking_tpu_torch.io.metadata import read_metadata
from cuking_tpu_torch.io.parquet_ingest import ingest_parquet
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models.king import PanelStorage
from cuking_tpu_torch.ops.bitset import DEFAULT_WORDS_MULTIPLE, PlaneLayout
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils.status import FailedPreconditionError
from cuking_tpu_torch.utils.synthetic import random_genotypes

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "input.parquet")


@pytest.fixture(scope="module")
def synthetic_input(tmp_path_factory):
    uri = str(tmp_path_factory.mktemp("ingest") / "in.parquet")
    g = random_genotypes(70, 1500, missing_rate=0.1, seed=41, num_related_pairs=2)
    write_synthetic_input(Storage(), uri, g, num_partitions=3)
    return uri


def _port_ingest(uri, split_factor, shard_index, use_native, panel=16):
    meta = read_metadata(Storage(), uri)
    port = PanelStorage(PlaneLayout.create(meta.num_sites),
                        Submatrix.create(meta.num_samples, split_factor, shard_index),
                        panel)
    ingest_parquet(Storage(), Storage().list_parquet_files(uri), port,
                   num_reader_threads=3, use_native=use_native)
    return port


def _ingest_both(uri, split_factor, shard_index, use_native, panel=16):
    """The port's planes (native packer or numpy path) and the JAX
    package's, always from its numpy path."""
    port = _port_ingest(uri, split_factor, shard_index, use_native, panel)
    meta = read_metadata(Storage(), uri)
    # The same words multiple as the port's default: byte-identical planes
    # need the same site → (word, bit) map.
    ref = JaxPanelStorage(
        JaxPlaneLayout.create(meta.num_sites, words_multiple=DEFAULT_WORDS_MULTIPLE),
        JaxSubmatrix.create(meta.num_samples, split_factor, shard_index), panel)
    jax_ingest(JaxStorage(), Storage().list_parquet_files(uri), ref,
               num_reader_threads=3, use_native=False)
    return port, ref


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("split_factor,shard_index", [(1, 0), (2, 0), (2, 1), (2, 2)])
@pytest.mark.parametrize("source", ["golden", "synthetic"])
def test_planes_byte_identical_with_jax(source, split_factor, shard_index,
                                        use_native, synthetic_input):
    from cuking_tpu_torch.native import packer

    if use_native and not packer.available():
        pytest.skip("native packer unavailable (no g++?)")
    uri = GOLDEN if source == "golden" else synthetic_input
    port, ref = _ingest_both(uri, split_factor, shard_index, use_native)
    assert port.version == ref.version == 1
    assert port.planes.dtype == ref.planes.dtype == np.uint32
    assert port.planes.tobytes() == ref.planes.tobytes()
    if use_native:
        numpy_path = _port_ingest(uri, split_factor, shard_index, use_native=False)
        assert port.planes.tobytes() == numpy_path.planes.tobytes()
    # Ingest really cleared bits (not two all-missing arrays).
    assert (port.planes != 0xFFFFFFFF).any()


def _write(path, arrays, names):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.Table.from_arrays(arrays, names=names), path)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("bad", ["n_alt", "schema", "columns", "null"])
def test_errors_match_jax(tmp_path, bad, use_native):
    path = str(tmp_path / "in" / "part-0.parquet")
    rows = pa.array([0, 1, 2], pa.int64())
    cols = pa.array([0, 1, 1], pa.int64())
    names = ["row_idx", "col_idx", "n_alt_alleles"]
    if bad == "n_alt":
        _write(path, [rows, cols, pa.array([0, 7, 1], pa.int32())], names)
    elif bad == "schema":
        _write(path, [rows, cols, pa.array([0, 1, 2], pa.int64())], names)
    elif bad == "columns":
        _write(path, [rows, cols], names[:2])
    else:
        _write(path, [rows, cols, pa.array([0, None, 1], pa.int32())], names)
    # The port as parametrised, the JAX package's numpy path, and with the
    # native packer the port's numpy path as well.
    runs = [(ingest_parquet, PanelStorage, PlaneLayout, Submatrix, Storage, use_native),
            (jax_ingest, JaxPanelStorage, JaxPlaneLayout, JaxSubmatrix, JaxStorage, False)]
    if use_native:
        runs.append((ingest_parquet, PanelStorage, PlaneLayout, Submatrix, Storage, False))
    messages = []
    for ingest, store, layout_cls, sub_cls, storage_cls, native in runs:
        ps = store(layout_cls.create(3, words_multiple=DEFAULT_WORDS_MULTIPLE),
                   sub_cls.create(2, 1, 0), 8)
        with pytest.raises(Exception) as e:
            ingest(storage_cls(), [path], ps, num_reader_threads=1,
                   use_native=native)
        messages.append((type(e.value).__name__, str(e.value)))
    assert all(m == messages[0] for m in messages[1:]), messages
    assert messages[0][0] == FailedPreconditionError.__name__


def test_native_cases_pass_where_the_jax_packer_failed_to_load(
        monkeypatch, synthetic_input, tmp_path):
    """A worker whose JAX packer failed to load sees ``available()`` False
    for the rest of its life.  The port's native cases must not care: one
    plane case and one error case pass there."""
    from cuking_tpu.native import packer as jax_packer

    monkeypatch.setattr(jax_packer, "available", lambda: False)
    test_planes_byte_identical_with_jax("synthetic", 2, 1, True, synthetic_input)
    test_errors_match_jax(tmp_path, "n_alt", True)
