"""Host-sharded storage, the ring capacity model and the CLI's mesh flags
(--use_mesh, --distributed, --allow_single_process, --capacity_per_device)
of the port, against the JAX package on conftest's 8-device CPU mesh.  In
one process every position is local; tests/test_torch_multiprocess.py runs
the same CLI across real processes."""

import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from cuking_tpu import cli as jax_cli
from cuking_tpu.io.parquet_ingest import ingest_parquet as jax_ingest
from cuking_tpu.io.uri import Storage as JaxStorage
from cuking_tpu.ops.bitset import PlaneLayout as JaxLayout
from cuking_tpu.parallel.distributed import HostShardedStorage as JaxHostSharded
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix
from cuking_tpu.utils import hbm as jax_hbm
from cuking_tpu.utils.status import InvalidArgumentError as JaxInvalidArgument
from cuking_tpu_torch import cli
from cuking_tpu_torch.io.metadata import read_metadata
from cuking_tpu_torch.io.parquet_ingest import ingest_parquet
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models.king import PanelStorage
from cuking_tpu_torch.ops.bitset import DEFAULT_WORDS_MULTIPLE, PlaneLayout
from cuking_tpu_torch.parallel.distributed import HostShardedStorage
from cuking_tpu_torch.parallel.ring import RingMesh
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils import hbm
from cuking_tpu_torch.utils.status import InvalidArgumentError
from cuking_tpu_torch.utils.synthetic import random_genotypes

from tests.test_torch_cli import read_output_rows

N = 43
CPU4 = "cpu,cpu,cpu,cpu"


@pytest.fixture(scope="module")
def input_uri(tmp_path_factory):
    uri = str(tmp_path_factory.mktemp("mesh") / "in.parquet")
    g = random_genotypes(N, 300, missing_rate=0.1, seed=41, num_related_pairs=3)
    write_synthetic_input(Storage(), uri, g, num_partitions=3)
    return uri


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("samples",))


# -- HostShardedStorage -------------------------------------------------------


@pytest.mark.parametrize("split_factor,shard_index,row_multiple", [
    (1, 0, 1), (1, 0, 8), (2, 0, 1), (2, 1, 1), (2, 2, 1), (3, 4, 4),
])
def test_ingest_surface_matches_jax(split_factor, shard_index, row_multiple):
    layout = PlaneLayout.create(100)
    sm = None if split_factor == 1 else Submatrix.create(N, split_factor, shard_index)
    jsm = None if sm is None else JaxSubmatrix.create(N, split_factor, shard_index)
    port = HostShardedStorage(layout, N, RingMesh(["cpu"] * 8), row_multiple, sm)
    ref = JaxHostSharded(JaxLayout.create(100, words_multiple=DEFAULT_WORDS_MULTIPLE),
                         N, jax_mesh(8), row_multiple, jsm)
    idx = np.arange(-3, N + 5)
    assert np.array_equal(port.contains(idx), ref.contains(idx))
    stored = idx[ref.contains(idx)]
    assert np.array_equal(port.storage_offsets(stored), ref.storage_offsets(stored))
    assert (port.nd, port.ranges) == (ref.nd, ref.ranges)
    assert port.planes.shape == ref.planes.shape


def test_ranks_partition_the_samples():
    """Positions split over two ranks: each rank stores only its own
    positions' rows, and together they store every sample exactly once."""
    layout = PlaneLayout.create(100)
    stores = [HostShardedStorage(layout, N, RingMesh(["cpu"] * 4, [0, 0, 1, 1], rank))
              for rank in (0, 1)]
    idx = np.arange(N)
    owned = [s.contains(idx) for s in stores]
    assert not (owned[0] & owned[1]).any() and (owned[0] | owned[1]).all()
    assert owned[0].sum() == 2 * stores[0].nd
    for s, mine in zip(stores, owned):
        offs = s.storage_offsets(idx[mine])
        assert sorted(offs.tolist()) == list(range(mine.sum()))


@pytest.mark.parametrize("split_factor,shard_index", [(1, 0), (2, 1)])
def test_host_sharded_ingest_equals_replicated(input_uri, split_factor, shard_index):
    """Host-sharded ingest gives the planes of the replicated ingest (the
    port's PanelStorage) and of the JAX package's host-sharded ingest."""
    meta = read_metadata(Storage(), input_uri)
    files = Storage().list_parquet_files(input_uri)
    layout = PlaneLayout.create(meta.num_sites)
    sm = Submatrix.create(N, split_factor, shard_index)
    port = HostShardedStorage(layout, N, RingMesh(["cpu"] * 8), submatrix=sm)
    ingest_parquet(Storage(), files, port, num_reader_threads=2)
    replicated = PanelStorage(layout, sm, 16)
    ingest_parquet(Storage(), files, replicated, num_reader_threads=2)
    ref = JaxHostSharded(JaxLayout.create(meta.num_sites, words_multiple=DEFAULT_WORDS_MULTIPLE),
                         N, jax_mesh(8), submatrix=JaxSubmatrix.create(N, split_factor, shard_index))
    # The JAX package's numpy path: its native packer is built in place and
    # may be unloadable in a test worker (see tests/test_torch_ingest.py).
    jax_ingest(JaxStorage(), files, ref, num_reader_threads=2, use_native=False)
    assert port.planes.tobytes() == ref.planes.tobytes()

    ranges = port.to_device_blocks()
    assert len(ranges) == (1 if sm.is_diagonal else 2)
    bases = [0, replicated.j_store_base]
    for blocks, (_, length), base in zip(ranges, port.ranges, bases):
        assert len(blocks) == 8 and {b.device.type for b in blocks} == {"cpu"}
        rows = torch.cat(blocks, dim=1).numpy().view(np.uint32)
        assert np.array_equal(rows[:, :length], replicated.planes[:, base:base + length])
        assert (rows[:, length:] == 0xFFFFFFFF).all()  # padding stays missing


# -- the ring capacity model -------------------------------------------------


@pytest.mark.parametrize("args,kw", [
    ((1000, 64, 128, 4096, 8), {}),                                     # fits
    ((1_000_000, 1 << 15, 1 << 17, 4096, 8), {}),                      # no split helps
    ((1_000_000, 1 << 15, 0, 4096, 8),
     dict(split_factor=1, panel=1024, row_multiple=256)),              # names a split
    ((1000, 64, 0, 4096, 8), dict(panel=16, max_results=1 << 20)),     # retry ceiling
    ((1000, 1 << 18, 1 << 16, 4096, 8), dict(split_factor=1, panel=16)),  # no prescription
])
def test_check_ring_fit_messages_match_jax(args, kw):
    n = args[0]
    limit = 8 << 20 if "max_results" in kw else 1 << 30
    results = []
    for mod, sub, err in ((hbm, Submatrix, InvalidArgumentError),
                          (jax_hbm, JaxSubmatrix, JaxInvalidArgument)):
        kw2 = dict(kw)
        if "panel" in kw2 and args[2] == 0:
            kw2["submatrix"] = sub.create(n, 1, 0)
        try:
            mod.check_ring_fit(*args, bytes_limit=limit, **kw2)
            results.append(None)
        except err as e:
            results.append(str(e))
    assert results[0] == results[1]


def test_check_ring_fit_counts_positions_per_device():
    """Four positions on one card need four times one position's bytes."""
    sm = Submatrix.create(32_768, 1, 0)
    one = hbm.ring_shard_bytes(32_768, 32_768, True, 3128, 1024, 1, 4, 1 << 20, 10 << 20)
    four = hbm.ring_shard_bytes(32_768, 32_768, True, 3128, 1024, 1, 4, 1 << 20,
                                10 << 20, positions_per_device=4)
    assert four == 4 * one
    kw = dict(submatrix=sm, panel=1024, split_factor=1, max_results=10 << 20)
    hbm.check_ring_fit(32_768, 3128, 0, 1 << 20, 4, 2 * one, **kw)
    with pytest.raises(InvalidArgumentError, match="split_factor to at least"):
        hbm.check_ring_fit(32_768, 3128, 0, 1 << 20, 4, 2 * one,
                           positions_per_device=4, **kw)


# -- the CLI on the mesh ------------------------------------------------------


def _both_clis(tmp_path, input_uri, port_args, jax_args, split_factor=1, threshold="0.05"):
    common = ["--input_uri", input_uri, "--kin_threshold", threshold, "--quiet",
              "--split_factor", str(split_factor)]
    for shard in range(split_factor * (split_factor + 1) // 2):
        shard_args = [*common, "--shard_index", str(shard)]
        assert cli.main([*shard_args, "--output_uri", str(tmp_path / "port"), *port_args]) == 0
        assert jax_cli.main([*shard_args, "--output_uri", str(tmp_path / "jax"),
                             "--kernel", "matmul", *jax_args]) == 0
    return read_output_rows(str(tmp_path / "port")), read_output_rows(str(tmp_path / "jax"))


@pytest.mark.parametrize("split_factor", [1, 2])
def test_use_mesh_cli_matches_jax(tmp_path, input_uri, split_factor):
    port, ref = _both_clis(tmp_path, input_uri, ["--use_mesh", "--device", CPU4],
                           ["--use_mesh"], split_factor)
    assert len(ref) >= 3
    assert port == ref


def test_distributed_single_process_cli_matches_jax(tmp_path, input_uri):
    """--distributed without a torchrun environment: one process, every
    position local, host-sharded ingest, partition shard x 1 + 0."""
    port, ref = _both_clis(tmp_path, input_uri, ["--distributed", "--device", CPU4],
                           ["--distributed"], 2, "-2.0")
    assert len(ref) == N * (N - 1) // 2
    assert port == ref
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_capacity_per_device_overflow_retries(tmp_path, input_uri):
    """--capacity_per_device 8 overflows every position; the ring retries
    at a pow2 bucket and the output equals the single-device run."""
    port, ref = _both_clis(tmp_path, input_uri,
                           ["--use_mesh", "--device", CPU4, "--capacity_per_device", "8"],
                           [], 1, "-2.0")
    assert len(ref) == N * (N - 1) // 2
    assert port == ref


def test_distributed_refuses_a_degraded_multi_process_run(tmp_path, input_uri,
                                                          monkeypatch, capsys):
    """MASTER_ADDR set but no RANK: the env:// rendezvous fails at once.
    In what looks like a multi-process run that is fatal unless
    --allow_single_process, and the error names the rendezvous's own
    complaint (the missing RANK); with no such variables the run goes on in
    one process."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_PORT", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    argv = ["--input_uri", input_uri, "--output_uri", str(tmp_path / "out"),
            "--kin_threshold", "0.05", "--distributed", "--device", "cpu,cpu", "--quiet"]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert "FAILED_PRECONDITION" in err and "MASTER_ADDR is set" in err
    assert "Cause: " in err and "RANK" in err.split("Cause: ")[1]
    assert not os.path.exists(tmp_path / "out")
    assert cli.main([*argv, "--allow_single_process"]) == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR")
    assert cli.main(argv) == 1
    assert "WORLD_SIZE=2" in capsys.readouterr().err
    monkeypatch.delenv("WORLD_SIZE")
    assert cli.main(argv) == 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("argv,message", [
    (["--device", "cpu,cpu"], "needs --use_mesh"),
    (["--use_mesh", "--device", "cpu,meta"], "one device type"),
    (["--use_mesh", "--device", "cpu,,cpu"], "Invalid --device"),
])
def test_device_list_validation(tmp_path, input_uri, argv, message, capsys):
    assert cli.main(["--input_uri", input_uri, "--output_uri", str(tmp_path / "o"),
                     *argv]) == 1
    assert message in capsys.readouterr().err
