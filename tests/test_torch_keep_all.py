"""The whole-matrix export (``--keep_all``) on the CPU: every pair i < j of a
shard written whatever its kin, against the benchmark's plain reference
(``kingbench/reference/every_pair.py``, plain PyTorch), on a diagonal and an
off-diagonal shard of a split-3 cohort with planted samples that have no
het site; the flag's refusals before ingest; a shard past
``--max_results`` refused up front, naming the value needed; the engine's
one sweep at exactly the shard's pairs; the emit step's plain version with
the flag; and the fit check's keep-all buffer.

One departure from the benchmark's comparison (``kingbench/check.py``,
kin as float32 bits): a pair whose kin is not finite is compared by
NaN-ness and sign, since the bits of a NaN are the arithmetic's, not
KING's.  This file imports no JAX."""

import contextlib
import io
import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuking_tpu_torch import cli
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models import king
from cuking_tpu_torch.models.king import KingConfig, KingEngine
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.ops.compaction import HitBuffer
from cuking_tpu_torch.ops.king_emit import emit_hits, emit_hits_plain
from cuking_tpu_torch.ops.king_math import KingCounts, king_from_counts
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils import stopwatch
from cuking_tpu_torch.utils.hbm import check_engine_fit, engine_plane_bytes, sweep_buffer_bytes
from cuking_tpu_torch.utils.status import InvalidArgumentError
from cuking_tpu_torch.utils.synthetic import random_counters, random_genotypes
from kingbench.reference.every_pair import shard_rows_all

SAMPLES, SITES, SPLIT = 150, 700, 3
# Samples with no het site: two hom-ref everywhere in block 0 (their pair's
# kin is 0/0, NaN) and one in block 1; each gives -inf with every other.
NO_HET = (3, 4, 60)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    g = random_genotypes(SAMPLES, SITES, missing_rate=0.05, seed=11, num_related_pairs=3)
    g[list(NO_HET)] = 0
    path = str(tmp_path_factory.mktemp("keep_all") / "input")
    write_synthetic_input(Storage(), path, g, num_partitions=3)
    return g, path


def reference(g: np.ndarray, sm: Submatrix) -> np.ndarray:
    codes = torch.from_numpy(g)
    j_ids = None if sm.is_diagonal else np.arange(sm.j_begin, sm.j_end)
    return shard_rows_all(lambda ids, lo, hi: codes[torch.as_tensor(ids), lo:hi],
                          np.arange(sm.i_begin, sm.i_end), j_ids, g.shape[1])


def assert_same_rows(got: np.ndarray, want: np.ndarray) -> None:
    """Equal rows; kin by its bits where finite, else by NaN-ness and sign."""
    assert got.shape == want.shape
    assert np.array_equal(got[:, [0, 1, 3, 4, 5]], want[:, [0, 1, 3, 4, 5]])
    kg = got[:, 2].astype(np.uint32).view(np.float32)
    kw = want[:, 2].astype(np.uint32).view(np.float32)
    finite = np.isfinite(kw)
    assert np.array_equal(got[finite, 2], want[finite, 2])
    assert np.array_equal(np.isnan(kg), np.isnan(kw))
    inf = np.isinf(kw)
    assert np.array_equal(kg[inf], kw[inf])


def read_rows(output_dir: str) -> np.ndarray:
    """The one output partition as int64 rows (i, j, kin bits, ibs0, ibs1,
    ibs2), sample IDs ``S<index>`` mapped back to indices, in the order
    written."""
    (name,) = os.listdir(output_dir)
    t = pq.read_table(os.path.join(output_dir, name)).to_pydict()
    ids = [[int(s[1:]) for s in t[c]] for c in ("i", "j")]
    kin = np.asarray(t["kin"], np.float32).view(np.uint32)
    return np.stack([*ids, kin, t["ibs0"], t["ibs1"], t["ibs2"]], axis=1).astype(np.int64)


def run_cli(*argv: str) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([*argv, "--device", "cpu"])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("shard", [0, 1, 4])  # blocks (0, 0), (0, 1), (1, 2)
def test_every_pair_of_the_shard_is_written_sorted(cohort, tmp_path, shard):
    g, path = cohort
    out = str(tmp_path / "out")
    rc, _, err = run_cli("--input_uri", path, "--output_uri", out, "--keep_all",
                         "--split_factor", str(SPLIT), "--shard_index", str(shard),
                         "--panel", "32")
    assert rc == 0, err
    sm = Submatrix.create(SAMPLES, SPLIT, shard)
    got, want = read_rows(out), reference(g, sm)
    assert len(got) == sm.unique_pairs == len(want)
    keys = got[:, 0] * SAMPLES + got[:, 1]
    assert np.all(np.diff(keys) > 0)  # sorted by (i, j), each pair once
    assert_same_rows(got, want)
    kin = got[:, 2].astype(np.uint32).view(np.float32)
    # The planted samples' rows are there: NaN where two of them pair, -inf
    # with everyone else.
    planted = np.isin(got[:, 0], NO_HET) | np.isin(got[:, 1], NO_HET)
    assert planted.any() and not np.isfinite(kin[planted]).any()
    assert np.isfinite(kin[~planted]).all()
    if shard == 0:
        assert np.isnan(kin[(got[:, 0] == 3) & (got[:, 1] == 4)]).all()


@pytest.mark.parametrize("extra,message", [
    (["--kin_threshold", "0.05"], "takes no --kin_threshold"),
    (["--use_mesh", "--device", "cpu,cpu"], "the ring"),
    (["--distributed"], "the ring"),
])
def test_keep_all_refuses_before_any_stage(tmp_path, extra, message):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["--input_uri", str(tmp_path / "none"), "--output_uri",
                       str(tmp_path / "out"), "--keep_all", *extra])
    assert rc == 1 and out.getvalue() == ""
    assert "INVALID_ARGUMENT" in err.getvalue() and message in err.getvalue()


def test_pairs_past_max_results_fail_up_front_naming_the_value(cohort, tmp_path):
    _, path = cohort
    pairs = Submatrix.create(SAMPLES, SPLIT, 1).unique_pairs
    rc, out, err = run_cli("--input_uri", path, "--output_uri", str(tmp_path / "out"),
                           "--keep_all", "--split_factor", str(SPLIT), "--shard_index", "1",
                           "--max_results", str(pairs - 1))
    assert rc == 1 and "RESOURCE_EXHAUSTED" in err
    assert f"--max_results {pairs} or more" in err
    assert "Allocating" not in out and "Processing Parquet" not in out
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("samples,split,shard", [(160, 1, 0), (160, 2, 1)])
def test_the_engine_sweeps_once_into_exactly_the_shards_pairs(samples, split, shard,
                                                              monkeypatch):
    """With a count copy and a wait every step asked for, a keep-all sweep
    runs once into a buffer of exactly the shard's pairs and waits for
    none; its rows are the reference's."""
    monkeypatch.setattr(king, "LIMIT_CHECK_STEPS", 1)
    monkeypatch.setattr(king, "LIMIT_CHECK_WINDOW", 1)
    g = random_genotypes(samples, 96, missing_rate=0.05, seed=5)
    g[7] = 2
    sm = Submatrix.create(samples, split, shard)
    engine = KingEngine.from_genotypes(g, KingConfig(panel=16, device="cpu", keep_all=True),
                                       submatrix=sm)
    engine.run()  # uploads
    stopwatch.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        rs = engine.run()
    spans = stopwatch.recorded()
    stopwatch.clear()
    (run,) = [s for s in spans if s.name == "engine.run"]
    assert run.counts == {"keep_all": 1, "sweeps": 1, "slots": sm.unique_pairs}
    assert not [s for s in spans if s.name == "engine.limit_wait"]
    (fetch,) = [s for s in spans if s.name == "engine.fetch"]
    assert fetch.counts == {"rows": sm.unique_pairs, "bytes": 24 * sm.unique_pairs}
    got = np.stack([rs.i_idx, rs.j_idx, rs.kin.view(np.uint32), rs.ibs0, rs.ibs1,
                    rs.ibs2], axis=1).astype(np.int64)
    assert_same_rows(got, reference(g, sm))


def test_a_thresholded_engine_records_its_buffer_and_no_keep_all():
    g = random_genotypes(64, 96, missing_rate=0.05, seed=5, num_related_pairs=2)
    engine = KingEngine.from_genotypes(g, KingConfig(panel=16, device="cpu"))
    stopwatch.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.run()
    (run,) = [s for s in stopwatch.recorded() if s.name == "engine.run"]
    stopwatch.clear()
    assert run.counts == {"keep_all": 0, "sweeps": 1,
                          "slots": KingConfig().resolved_result_capacity()}


@pytest.mark.parametrize("strict,sym", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("gi,gj,il,jl", [(0, 0, 300, 450), (0, 100, 260, 420),
                                         (20, 100, 200, 500)])
def test_plain_emit_with_the_flag_keeps_every_pair_inside_the_limits(strict, sym, gi, gj,
                                                                     il, jl):
    """Random counters with NaN and -inf rows: every candidate is a row,
    kin bits as the epilogue gives them, whatever the threshold."""
    counts = KingCounts(*torch.from_numpy(
        random_counters(300, 450, np.random.default_rng(3))).unbind(0))
    hits = HitBuffer(1 << 18, "cpu")
    emit_hits_plain(counts, hits, gi, gj, il, jl, 1e9, strict, sym, keep_all=True)
    li, lj = np.meshgrid(np.arange(300), np.arange(450), indexing="ij")
    i, j = gi + li, gj + lj
    cand = (i < il) & (j < jl) & ((i < j) if strict else True)
    total = int(hits.count)
    assert total == cand.sum() > 0
    kin = king_from_counts(counts).kin.numpy().view(np.int32)
    rows = hits.rows(total)
    got = sorted(map(tuple, rows.T.tolist()))
    ii, jj = i[cand], j[cand]
    if sym:
        ii, jj = np.minimum(ii, jj), np.maximum(ii, jj)
    assert sorted(zip(ii.tolist(), jj.tolist(), kin[cand].tolist())) == [r[:3] for r in got]
    assert np.isnan(rows[2].view(np.float32)).any()
    assert np.isneginf(rows[2].view(np.float32)).any()
    # emit_hits takes the same flag to the same place on the CPU.
    again = HitBuffer(1 << 18, "cpu")
    emit_hits(counts, again, gi, gj, il, jl, 1e9, strict, sym, keep_all=True)
    assert sorted(map(tuple, again.rows(int(again.count)).T.tolist())) == got


def test_the_fit_check_counts_the_keep_all_buffer():
    sm = Submatrix.create(3202, 1, 0)
    words = PlaneLayout.create(93_511).words
    config = KingConfig(device="cpu", keep_all=True)
    need = engine_plane_bytes(sm, words, config.panel) + sweep_buffer_bytes(
        config, sm.unique_pairs)
    assert engine_plane_bytes(sm, words, config.panel) == 95_813_632
    assert sweep_buffer_bytes(config, sm.unique_pairs) - sweep_buffer_bytes(config, 0) == (
        24 * (sm.unique_pairs - 1))
    check_engine_fit(3202, words, sm, config, 1, bytes_limit=need)
    with pytest.raises(InvalidArgumentError, match="--split_factor to at least 2"):
        check_engine_fit(3202, words, sm, config, 1, bytes_limit=need - 1)
