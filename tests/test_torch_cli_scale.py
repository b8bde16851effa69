"""``tools/torch_cli_at_scale.py`` on the CPU at a small size (600 samples x
4,000 sites in 6 site-ordered files, planted clone and half-copy
families): its genotypes are random access, the port's CLI on its input
equals the JAX CLI row for row and the planted pairs, its plane and tally
checks catch one flipped bit and one missing file, and ingest sizes its
pools by the CPUs the process may run on."""

import importlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow.parquet as pq
import pytest

from cuking_tpu import cli as jax_cli
from cuking_tpu_torch import cli
from cuking_tpu_torch.io import parquet_ingest
from cuking_tpu_torch.io.metadata import read_metadata
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models.king import PanelStorage
from cuking_tpu_torch.native import packer
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.parallel.submatrix import Submatrix

tool = importlib.import_module("tools.torch_cli_at_scale")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COHORT = tool.Cohort(samples=600, sites=4000, files=6, sites_per_file=667, seed=11)
SMALL = ["--samples", "600", "--sites", "4000", "--files", "6", "--sites-per-file", "667"]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    inp = str(tmp_path_factory.mktemp("cli_scale") / "in.parquet")
    return inp, tool.write_input(COHORT, inp, threads=3)


def _ingest(inp, files=None, split_factor=1, threads=36):
    storage = Storage()
    meta = read_metadata(storage, inp)
    st = PanelStorage(PlaneLayout.create(meta.num_sites),
                      Submatrix.create(meta.num_samples, split_factor, 0), 1024)
    parquet_ingest.ingest_parquet(storage, files or storage.list_parquet_files(inp), st,
                                  num_reader_threads=threads)
    return st


def test_input_is_site_ordered_and_rows_regenerate(written):
    """Each file holds its run of sites, site by site with samples
    ascending, and a row regenerated from the seed equals the row read back
    from the files; the tallies count every entry."""
    inp, w = written
    files = Storage().list_parquet_files(inp)
    assert len(files) == COHORT.files
    rows = np.array([0, 1, 599, *COHORT.families[1][0][:3]])
    back = np.full((len(rows), COHORT.sites), -1, np.int8)
    for f, path in enumerate(sorted(files)):
        t = pq.read_table(path)
        site, sample, n_alt = (t.column(k).to_numpy() for k in range(3))
        assert np.array_equal(np.unique(site), COHORT.file_sites(f))
        order = site * COHORT.samples + sample
        assert (np.diff(order) > 0).all()
        for k, r in enumerate(rows):
            sel = sample == r
            back[k, site[sel]] = n_alt[sel]
    assert np.array_equal(back, COHORT.genotypes(rows, np.arange(COHORT.sites)))
    assert sum(w["tallies"]) == w["entries"]
    assert w["entries"] == np.count_nonzero(
        COHORT.genotypes(np.arange(COHORT.samples), np.arange(COHORT.sites)) >= 0)


def test_families_are_planted_as_described():
    fams = COHORT.families
    assert list(fams[0][0]) == [0, 599] and not fams[0][1]
    assert any(is_half for _, is_half in fams) and any(not h for _, h in fams)
    g = COHORT.genotypes(fams[0][0], np.arange(COHORT.sites))
    assert np.array_equal(g[0], g[1])
    rows, _ = next(f for f in fams if f[1])
    g = COHORT.genotypes(rows[:2], np.arange(COHORT.sites))
    same = np.mean(g[0] == g[1])
    assert 0.5 < same < 0.9  # a half copied, the rest drawn on its own


def test_port_cli_equals_the_jax_cli_and_the_planted_pairs(written, tmp_path, capsys):
    inp, _ = written
    common = ["--input_uri", inp, "--kin_threshold", str(tool.THRESHOLD)]
    assert cli.main([*common, "--output_uri", str(tmp_path / "port"), "--device", "cpu"]) == 0
    stages = tool.stage_seconds(capsys.readouterr().out)
    assert set(stages) == set(tool._STAGES)  # the allocation is a logged stage
    assert jax_cli.main([*common, "--output_uri", str(tmp_path / "jax"), "--kernel", "matmul",
                         "--quiet"]) == 0
    port, ref = tool.read_output(str(tmp_path / "port")), tool.read_output(str(tmp_path / "jax"))
    want = tool.expected_rows(COHORT)
    assert len(want) == 1258
    assert port == ref == want


def test_plane_check_catches_one_flipped_bit(written):
    inp, _ = written
    st = _ingest(inp)
    rows = tool.checked_rows(COHORT)
    assert len(rows) >= 256 and {0, 599} <= set(rows.tolist())
    assert tool.plane_mismatches(st.planes, st.storage_offsets(rows), COHORT, rows) == []
    r = int(COHORT.families[1][0][0])
    st.planes[1, r, 17] ^= np.uint32(1 << 3)
    assert tool.plane_mismatches(st.planes, st.storage_offsets(rows), COHORT, rows) == [r]


def test_tally_check_catches_a_missing_file(written):
    inp, w = written
    files = sorted(Storage().list_parquet_files(inp))
    assert tool.plane_tallies(_ingest(inp).planes, threads=2, block=128) == w["tallies"]
    short = tool.plane_tallies(_ingest(inp, files[:-1]).planes, threads=2, block=128)
    assert short != w["tallies"]
    assert np.array_equal(np.array(w["tallies"]) - short, w["file_tallies"][-1])


class _RecordingPool(ThreadPoolExecutor):
    sizes: list = []

    def __init__(self, max_workers=None, **kw):
        _RecordingPool.sizes.append(max_workers)
        super().__init__(max_workers=max_workers, **kw)


class _RecordingLib:
    """The packer's library, recording each call's thread count."""

    def __init__(self, lib):
        self._lib, self.threads = lib, []

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def cuking_clear_bits(self, *args):
        self.threads.append(args[-1])
        return self._lib.cuking_clear_bits(*args)


def test_ingest_pools_follow_the_affinity_mask(written, monkeypatch):
    """With the process confined to two CPUs the decode pool has two
    workers, a packer call takes the CPUs the busy decoders leave (one
    each with six files, both with one file), the packer's default is two
    threads a call, and the planes do not change; os.cpu_count() still
    counts the host."""
    if not packer.available():
        pytest.skip("no C++ compiler for the native packer")
    inp, _ = written
    one = sorted(Storage().list_parquet_files(inp))[:1]
    before, before_one = _ingest(inp).planes, _ingest(inp, one).planes
    lib = _RecordingLib(packer._load())
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    monkeypatch.setattr(packer, "_load", lambda: lib)
    monkeypatch.setattr(parquet_ingest, "ThreadPoolExecutor", _RecordingPool)
    _RecordingPool.sizes = []
    after = _ingest(inp, threads=36).planes
    assert _RecordingPool.sizes == [2, 36]  # decoders, then readers
    assert lib.threads == [1] * COHORT.files
    assert packer.usable_cpus() == 2
    assert np.array_equal(after, before)
    lib.threads.clear()
    assert np.array_equal(_ingest(inp, one).planes, before_one)
    assert lib.threads == [2]
    lib.threads.clear()
    g = COHORT.genotypes(np.arange(4), np.arange(COHORT.sites))
    planes = np.full((2, 4, PlaneLayout.create(COHORT.sites).words), 0xFFFFFFFF, np.uint32)
    sample, site = np.nonzero(g >= 0)
    packer.clear_bits(planes, PlaneLayout.create(COHORT.sites), sample, site,
                      g[sample, site].astype(np.int32))
    assert lib.threads == [2]


def test_tool_runs_the_cell_on_the_cpu(tmp_path, capsys):
    """The whole tool on the plain path: the task, its checks and one run
    of each ingest setting, with every entry read and every check passed."""
    assert tool.main([*SMALL, "--device", "cpu", "--ingest-runs", "1", "--ab-runs", "1",
                      "--workdir", str(tmp_path)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["ok"] and result["failures"] == []
    assert result["output"]["rows"] == result["output"]["planted_pairs"] == 1258
    assert result["task"]["rows_differing"] == []
    assert result["task"]["plane_tallies"] == result["input"]["tallies"]
    assert set(result["task"]["stages_s"]) >= {"allocate", "ingest", "upload", "sweep", "write"}
    assert [(r["setting"], r["split_factor"]) for r in result["ingest"]] == [
        *((s, 1) for s in tool.AB_SETTINGS), ("package", 1), ("package", 1), ("package", 2)]
    assert [r["cpus"] for r in result["ingest"]][-3:] == [
        result["cpus"], max(1, result["cpus"] // 2), result["cpus"]]
    calls = [r["packer_threads_per_call"] for r in result["ingest"]]
    assert calls[1] == calls[3] == {"1": 6}  # one packer thread a call, forced
    for r in result["ingest"]:
        assert r["entries"] == result["input"]["entries"]
        assert 1 <= r["decoders"] <= r["usable_cpus"] == r["cpus"]
    split2 = result["ingest"][-1]
    assert 0 < split2["kept"] < split2["entries"]
    assert os.listdir(tmp_path) == []  # the input is deleted


def test_tool_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(SMALL) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_tool_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from tools import torch_cli_at_scale as t; "
            "c = t.Cohort(samples=64, sites=500, files=2, sites_per_file=100); "
            "t.expected_rows(c); t.file_entries(c, 1); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'cuking_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
