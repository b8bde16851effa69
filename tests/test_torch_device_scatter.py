"""Ingest into planes that live on a device (``ops/king_scatter.py``), on the
CPU: the scatter kernel's plain version against ``bitset.clear_bits_coo``
bit for bit, and both against the JAX package's ``clear_bits_coo``; the
staging path of ``ingest_parquet`` (planes built with
``PanelStorage(device=...)``, here a CPU tensor) against the host planes,
with files larger than a staging slot; the checks that raise before any
record of a file is sent; concurrent senders; the engine sweeping such
planes as they are; the CLI's choice of host planes on a CPU device; and
the fit model's staging term.  The kernel itself is held to the same
references on the card in ``tests/test_torch_gpu.py``."""

import os
import sys
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from cuking_tpu.ops import bitset as jax_bitset
from cuking_tpu.ops.bitset import PlaneLayout as JaxPlaneLayout

from cuking_tpu_torch import cli
from cuking_tpu_torch.io.metadata import read_metadata
from cuking_tpu_torch.io.parquet_ingest import ingest_parquet
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
from cuking_tpu_torch.ops import bitset, king_scatter
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.ops.king_scatter import (
    Stager,
    pack_records,
    scatter_records,
    scatter_records_plain,
)
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils import stopwatch
from cuking_tpu_torch.utils.hbm import (
    STAGING_BYTES,
    check_engine_fit,
    engine_plane_bytes,
    sweep_buffer_bytes,
)
from cuking_tpu_torch.utils.status import FailedPreconditionError, InvalidArgumentError
from cuking_tpu_torch.utils.synthetic import random_genotypes


def random_entries(storage: PanelStorage, n: int, seed: int):
    """(storage rows, sites, n_alt) of ``n`` random entries of the shard's
    samples: every n_alt, and a third of them repeats of earlier entries
    with another n_alt."""
    rng = np.random.default_rng(seed)
    stored = storage.submatrix.stored_sample_indices()
    samples = rng.choice(stored, n)
    sites = rng.integers(0, storage.layout.num_sites, n)
    n_alt = rng.integers(0, 3, n).astype(np.int32)
    dup = rng.integers(0, n, n // 3)
    samples[: len(dup)], sites[: len(dup)] = samples[dup], sites[dup]
    return storage.storage_offsets(samples), sites, n_alt


def jax_layout(layout: PlaneLayout) -> JaxPlaneLayout:
    """The JAX package's layout of the same words (its default multiple is
    64 words, the port's 4)."""
    return JaxPlaneLayout.create(layout.num_sites, words_multiple=layout.words)


def records_of(rows, sites, n_alt) -> torch.Tensor:
    out = np.empty((2, len(n_alt)), np.int32)
    pack_records(out, rows, sites, n_alt)
    return torch.from_numpy(out)


@pytest.mark.parametrize("sites,samples,split,shard", [
    (1_000_000, 200, 5, 4),   # 31,252 words; off-diagonal: the j range stored after i
    (93_511, 300, 1, 0),      # 2,924 words
    (100, 70, 2, 1),          # 4 words: padding sites in every word
    (33, 40, 3, 5),           # one site past a word's 32
])
def test_plain_scatter_equals_clear_bits_coo(sites, samples, split, shard):
    layout = PlaneLayout.create(sites)
    host = PanelStorage(layout, Submatrix.create(samples, split, shard), 16)
    rows, site_idx, n_alt = random_entries(host, 20_000, seed=sites)
    assert set(np.unique(n_alt)) == {0, 1, 2}
    bitset.clear_bits_coo(host.planes, layout, rows, site_idx, n_alt)
    reference = np.full_like(host.planes, 0xFFFFFFFF)
    jax_bitset.clear_bits_coo(reference, jax_layout(layout), rows, site_idx, n_alt)
    assert np.array_equal(reference, host.planes)
    planes = torch.full(host.planes.shape, -1, dtype=torch.int32)
    scatter_records_plain(planes, records_of(rows, site_idx, n_alt))
    assert np.array_equal(planes.numpy().view(np.uint32), host.planes)
    again = torch.full(host.planes.shape, -1, dtype=torch.int32)
    scatter_records(again, records_of(rows, site_idx, n_alt))
    assert torch.equal(again, planes)
    # Padding rows and padding sites are untouched: all ones.
    stored = set(rows.tolist())
    padding = [r for r in range(planes.shape[1]) if r not in stored]
    assert padding and (planes[:, padding] == -1).all()
    if layout.padded_sites > sites:
        unpacked = bitset.unpack_plane_np(host.planes[0], layout)
        assert unpacked[:, sites:].all()


def test_plain_scatter_decodes_sites_past_2_29():
    """Sites of 2**29 or more set a record's top bit; the plain version
    reads the code as uint32, as the kernel does.  One stored row keeps the
    planes at 2 x 16,809,988 words."""
    sites = (1 << 29) + (1 << 20)
    layout = PlaneLayout.create(sites)
    rng = np.random.default_rng(29)
    n = 3_000
    site_idx = np.concatenate([rng.integers(1 << 29, sites, n - 100),
                               rng.integers(0, 1 << 29, 100)])
    site_idx[:300] = site_idx[300:600]  # repeats, with another n_alt
    site_idx[-1] = sites - 1
    rows = np.zeros(n, np.int64)
    n_alt = rng.integers(0, 3, n).astype(np.int32)
    host = np.full((2, 1, layout.words), 0xFFFFFFFF, np.uint32)
    jax_bitset.clear_bits_coo(host, jax_layout(layout), rows, site_idx, n_alt)
    planes = torch.full(host.shape, -1, dtype=torch.int32)
    records = records_of(rows, site_idx, n_alt)
    assert (records[1] < 0).sum() == (site_idx >= 1 << 29).sum() > n // 2
    scatter_records_plain(planes, records)
    assert np.array_equal(planes.numpy().view(np.uint32), host)
    assert (host != 0xFFFFFFFF).sum() > 0


def test_pack_records_layout():
    out = np.empty((2, 3), np.int32)
    pack_records(out, np.array([0, 5, 2**31 - 1], np.int64),
                 np.array([0, 7, 2**29], np.int64), np.array([2, 0, 1], np.int32))
    assert out[0].tolist() == [0, 5, 2**31 - 1]
    assert out[1].view(np.uint32).tolist() == [2, 28, (2**29 << 2) | 1]


@pytest.fixture(scope="module")
def parquet_input(tmp_path_factory):
    uri = str(tmp_path_factory.mktemp("device_scatter") / "in.parquet")
    g = random_genotypes(70, 1500, missing_rate=0.1, seed=43, num_related_pairs=2)
    write_synthetic_input(Storage(), uri, g, num_partitions=3)
    return uri


def _ingest(uri, split, shard, device=None, **kw):
    meta = read_metadata(Storage(), uri)
    st = PanelStorage(PlaneLayout.create(meta.num_sites),
                      Submatrix.create(meta.num_samples, split, shard), 16, device=device)
    ingest_parquet(Storage(), Storage().list_parquet_files(uri), st,
                   num_reader_threads=3, **kw)
    return st


@pytest.mark.parametrize("slot_records", [1_000, 1 << 20])
@pytest.mark.parametrize("split,shard", [(1, 0), (2, 0), (2, 1)])
def test_ingest_into_device_planes_equals_host_planes(monkeypatch, parquet_input,
                                                      split, shard, slot_records):
    """A file of ~35,000 entries goes in one slot, or in many of 1,000."""
    monkeypatch.setattr(king_scatter, "STAGING_BYTES", slot_records * king_scatter.RECORD_BYTES)
    host = _ingest(parquet_input, split, shard, use_native=False)
    dev = _ingest(parquet_input, split, shard, device="cpu")
    assert isinstance(dev.planes, torch.Tensor) and dev.planes.dtype == torch.int32
    assert dev.version == host.version == 1
    assert np.array_equal(dev.planes.numpy().view(np.uint32), host.planes)
    assert (host.planes != 0xFFFFFFFF).any()


def _write(path, sites, samples, n_alt):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.Table.from_arrays(
        [pa.array(sites, pa.int64()), pa.array(samples, pa.int64()),
         pa.array(n_alt, pa.int32())], names=["row_idx", "col_idx", "n_alt_alleles"]), path)


@pytest.mark.parametrize("bad,value,message", [
    ("n_alt", 7, "Invalid value for n_alt_alleles (7) encountered in"),
    ("n_alt", -1, "Invalid value for n_alt_alleles (-1) encountered in"),
    ("site", 3000, "Site index 3000 out of range [0, 3000) in"),
    ("site", -2, "Site index -2 out of range [0, 3000) in"),
])
def test_invalid_entries_raise_before_any_record_is_sent(tmp_path, monkeypatch, bad,
                                                         value, message):
    """The bad entry is the file's last, several slots after its first: no
    record of the file reaches the planes."""
    monkeypatch.setattr(king_scatter, "STAGING_BYTES", 100 * king_scatter.RECORD_BYTES)
    n = 1_000
    sites, samples = np.arange(n) % 3000, np.arange(n) % 8
    n_alt = np.zeros(n, np.int32)
    (n_alt if bad == "n_alt" else sites)[-1] = value
    path = str(tmp_path / "in" / "part-0.parquet")
    _write(path, sites, samples, n_alt)
    st = PanelStorage(PlaneLayout.create(3000), Submatrix.create(8, 1, 0), 8, device="cpu")
    with pytest.raises(FailedPreconditionError) as e:
        ingest_parquet(Storage(), [path], st, num_reader_threads=1)
    assert str(e.value).endswith(f": {message} {path}")
    assert (st.planes == -1).all()
    assert st.version == 1


def test_concurrent_senders_clear_every_entry(monkeypatch):
    """More sending threads than CPUs, slots of 64 records and a short
    switch interval: the planes hold every clear of every thread."""
    monkeypatch.setattr(king_scatter, "STAGING_BYTES", 64 * king_scatter.RECORD_BYTES)
    layout = PlaneLayout.create(5_000)
    host = PanelStorage(layout, Submatrix.create(64, 1, 0), 64)
    parts = [random_entries(host, 3_000, seed=k) for k in range(2 * (os.cpu_count() or 1) + 2)]
    for rows, sites, n_alt in parts:
        bitset.clear_bits_coo(host.planes, layout, rows, sites, n_alt)
    planes = torch.full(host.planes.shape, -1, dtype=torch.int32)
    stager = Stager(planes, layout)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=stager.send, args=(*part, f"file {k}"))
                   for k, part in enumerate(parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    stager.close()
    assert np.array_equal(planes.numpy().view(np.uint32), host.planes)


def test_engine_sweeps_device_planes_as_they_are(parquet_input):
    """The engine takes the storage's tensor as its planes (no upload, no
    ``engine.upload`` span) and finds the rows of host planes."""
    config = KingConfig(panel=64, device="cpu", kin_threshold=-2.0, site_chunk_words=16)
    host = _ingest(parquet_input, 2, 1, use_native=False)
    dev = _ingest(parquet_input, 2, 1, device="cpu")
    engine = KingEngine(dev, config)
    assert engine.planes_dev is dev.planes
    stopwatch.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = engine.run()
    names = {s.name for s in stopwatch.recorded()}
    stopwatch.clear()
    assert "engine.run" in names and "engine.upload" not in names
    ref = KingEngine(host, config).run()
    assert len(got) == len(ref) > 0
    for field in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, field), getattr(ref, field))
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))


def test_cli_on_a_cpu_device_builds_host_planes(parquet_input, tmp_path, monkeypatch, capsys):
    seen = []
    ingest = cli.ingest_parquet

    def captured(storage, files, panel_storage, **kw):
        seen.append(panel_storage)
        return ingest(storage, files, panel_storage, **kw)

    monkeypatch.setattr(cli, "ingest_parquet", captured)
    assert cli.main(["--input_uri", parquet_input, "--output_uri", str(tmp_path / "out"),
                     "--device", "cpu"]) == 0
    (st,) = seen
    assert isinstance(st.planes, np.ndarray) and st.planes.dtype == np.uint32
    assert f"Allocated {st.planes.nbytes >> 20} MiB of memory for bit planes on the host." \
        in capsys.readouterr().out


@pytest.mark.parametrize("samples,sites,split,shard,keep_all", [
    (40_960, 1_000_000, 5, 4, False),   # gnomad_v4.task's shard
    (3_202, 93_511, 1, 0, True),        # kgp30x.export's keep-all task
    (65_536, 93_511, 1, 0, False),      # a split-1 UK Biobank task
])
def test_staging_pool_leaves_the_admitted_shard_unchanged(samples, sites, split, shard,
                                                          keep_all):
    """Ingest's pool is smaller than the sweep's buffers at the CLI's
    defaults, so the fit model's need is planes + buffers as before."""
    sm = Submatrix.create(samples, split, shard)
    config = KingConfig(device="cuda", keep_all=keep_all)
    buffers = sweep_buffer_bytes(config, sm.unique_pairs)
    assert STAGING_BYTES <= buffers
    words = PlaneLayout.create(sites).words
    need = engine_plane_bytes(sm, words, config.panel) + buffers
    check_engine_fit(samples, words, sm, config, split, bytes_limit=need)
    with pytest.raises(InvalidArgumentError, match="split_factor"):
        check_engine_fit(samples, words, sm, config, split, bytes_limit=need - 1)


def test_fit_model_counts_the_pool_where_the_buffers_are_smaller():
    sm = Submatrix.create(200, 1, 0)
    config = KingConfig(device="cuda", panel=128, max_results=10, result_capacity=10)
    buffers = sweep_buffer_bytes(config, sm.unique_pairs)
    assert buffers < STAGING_BYTES
    words = PlaneLayout.create(1000).words
    planes = engine_plane_bytes(sm, words, config.panel)
    check_engine_fit(200, words, sm, config, 1, bytes_limit=planes + STAGING_BYTES)
    with pytest.raises(InvalidArgumentError, match="split_factor"):
        check_engine_fit(200, words, sm, config, 1,
                         bytes_limit=planes + STAGING_BYTES - 1)


def test_chip_smoke_reads_scatter_launches_by_path():
    """``chip_smoke.py`` zeroes the scatter kernel's count with the sweep's
    before each path and fails a path whose planes went the wrong way: a
    CLI task on the card that launched no scatter kernel, or a path on host
    planes that launched one."""
    import chip_smoke

    chip_smoke.reset_launches()
    assert chip_smoke.read_launches("nothing", ()) == dict.fromkeys(chip_smoke.KERNELS, 0)
    with pytest.raises(RuntimeError, match="launched no king_scatter kernel"):
        chip_smoke.read_launches("a CLI task on the card", ("king_scatter",))
    king_scatter.launches = 2
    with pytest.raises(RuntimeError, match="launched 2 scatter kernels on host planes"):
        chip_smoke.read_launches("the engine on host planes", ())
    assert chip_smoke.read_launches("a CLI task on the card", ("king_scatter",)) == {
        "king_counts": 0, "king_emit": 0, "king_scatter": 2}
    chip_smoke.reset_launches()
    assert king_scatter.launches == 0
