"""The port's KingEngine (device cpu: the plain count path) against the JAX
KingEngine running its Pallas kernel in interpret mode (as
tests/test_engine.py runs it): identical ResultSets, kin compared as uint32
bits, for every shard of split factors 1 and 2 at two thresholds, through
the result buffer's overflow re-run, and with the same max_results overflow
error, which a sweep raises after waiting for the count copy
``LIMIT_CHECK_WINDOW`` copies behind the newest."""

import io

import numpy as np
import pytest

from cuking_tpu.models.king import KingConfig as JaxConfig
from cuking_tpu.models.king import KingEngine as JaxEngine
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix
from cuking_tpu.utils.status import ResourceExhaustedError as JaxResourceExhausted
from cuking_tpu.utils.stopwatch import StageLogger as JaxStageLogger
import torch
from torch.profiler import ProfilerActivity, profile

from cuking_tpu_torch.models import king as torch_king
from cuking_tpu_torch.models.king import KingConfig, KingEngine, resolve_kernel_name
from cuking_tpu_torch.ops.compaction import HitBuffer
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils.hbm import check_engine_fit
from cuking_tpu_torch.utils.status import InvalidArgumentError, ResourceExhaustedError
from cuking_tpu_torch.utils import stopwatch
from cuking_tpu_torch.utils.stopwatch import StageLogger
from cuking_tpu_torch.utils.synthetic import random_genotypes

N, SITES = 48, 700
JAX_KW = dict(kernel="pallas", pallas_interpret=True, site_chunk_words=8,
              tile_i=8, tile_j=8, sweep_batch=4)


@pytest.fixture(scope="module")
def genotypes():
    return random_genotypes(N, SITES, missing_rate=0.08, seed=11,
                            num_related_pairs=3)


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))


@pytest.mark.parametrize("threshold", [0.0884, -2.0])
@pytest.mark.parametrize("split_factor,shard_index", [(1, 0), (2, 0), (2, 1), (2, 2)])
def test_engine_matches_jax_pallas(genotypes, split_factor, shard_index, threshold):
    common = dict(panel=16, kin_threshold=threshold, max_results=N * N)
    ref = JaxEngine.from_genotypes(
        genotypes, JaxConfig(**common, **JAX_KW),
        submatrix=JaxSubmatrix.create(N, split_factor, shard_index)).run()
    got = KingEngine.from_genotypes(
        genotypes, KingConfig(**common, device="cpu", site_chunk_words=8),
        submatrix=Submatrix.create(N, split_factor, shard_index)).run()
    assert len(ref) > 0
    _assert_same(got, ref)


def _overflow_lines(log: str) -> list[str]:
    return [ln for ln in log.splitlines() if "Result buffer overflowed" in ln]


def test_result_buffer_growth_matches_jax(genotypes):
    """A 3-slot buffer overflows; the exact count re-runs the sweep once at
    2,048 slots, which hold all 1,128 pairs, with JAX's log line."""
    common = dict(panel=16, kin_threshold=-2.0, max_results=N * N,
                  result_capacity=3)
    jax_engine = JaxEngine.from_genotypes(genotypes, JaxConfig(**common, **JAX_KW))
    jax_engine.logger = JaxStageLogger(stream=(jax_log := io.StringIO()))
    ref = jax_engine.run()
    engine = KingEngine.from_genotypes(genotypes, KingConfig(**common, device="cpu"))
    engine.logger = StageLogger(stream=(log := io.StringIO()))
    got = engine.run()
    assert len(got) == N * (N - 1) // 2
    _assert_same(got, ref)
    assert _overflow_lines(log.getvalue()) == _overflow_lines(jax_log.getvalue()) == [
        "Result buffer overflowed (1128 hits > 3 slots); re-running at capacity 2048."]


def test_one_engine_builds_its_schedule_once(genotypes, monkeypatch):
    """Two runs of one engine, each through the overflow re-run, build the
    schedule once: one ``_panel_pair_params`` call, in one
    ``engine.schedule`` span inside the first run's ``engine.run``.  Both
    runs' rows are a fresh engine's."""
    calls = []
    params = KingEngine._panel_pair_params

    def counted(self):
        calls.append(self)
        return params(self)

    monkeypatch.setattr(KingEngine, "_panel_pair_params", counted)
    common = dict(panel=16, kin_threshold=-2.0, max_results=N * N, device="cpu")
    engine = KingEngine.from_genotypes(genotypes, KingConfig(**common, result_capacity=3))
    stopwatch.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [engine.run(), engine.run()]
    spans = stopwatch.recorded()
    stopwatch.clear()
    assert calls == [engine]
    (schedule,) = [s for s in spans if s.name == "engine.schedule"]
    runs = [s for s in spans if s.name == "engine.run"]
    assert [r.counts["sweeps"] for r in runs] == [2, 2]
    assert schedule.parent == runs[0].id and schedule.counts == {"steps": 6}
    ref = KingEngine.from_genotypes(genotypes, KingConfig(**common)).run()
    assert len(ref) == N * (N - 1) // 2
    for rows in got:
        _assert_same(rows, ref)


def test_max_results_overflow_matches_jax(genotypes):
    common = dict(panel=16, kin_threshold=-2.0, max_results=100)
    with pytest.raises(JaxResourceExhausted) as ref:
        JaxEngine.from_genotypes(genotypes, JaxConfig(**common, **JAX_KW)).run()
    with pytest.raises(ResourceExhaustedError) as got:
        KingEngine.from_genotypes(genotypes, KingConfig(**common, device="cpu")).run()
    assert str(got.value) == str(ref.value)


def test_duplicates_give_kin_one_half_exactly():
    g = random_genotypes(40, 900, missing_rate=0.05, seed=5)
    g[33] = g[7]
    rs = KingEngine.from_genotypes(g, KingConfig(panel=16, device="cpu")).run()
    assert (rs.i_idx.tolist(), rs.j_idx.tolist()) == ([7], [33])
    assert rs.kin.view(np.uint32)[0] == np.float32(0.5).view(np.uint32)
    assert rs.ibs0[0] == rs.ibs1[0] == 0
    assert rs.ibs2[0] == int((g[7] >= 0).sum())


def test_popcount_engine_matches_jax_popcount(genotypes):
    common = dict(panel=16, kin_threshold=-2.0, max_results=N * N, kernel="popcount",
                  popcount_row_block=3)
    ref = JaxEngine.from_genotypes(genotypes, JaxConfig(**common)).run()
    got = KingEngine.from_genotypes(genotypes, KingConfig(**common, device="cpu")).run()
    _assert_same(got, ref)


def test_kernel_resolution():
    assert resolve_kernel_name(KingConfig(device="cpu")) == "matmul"
    assert resolve_kernel_name(KingConfig(kernel="popcount", device="cuda")) == "popcount"
    assert resolve_kernel_name(KingConfig(device="cuda")) == "cuda"
    with pytest.raises(InvalidArgumentError, match="needs a CUDA device"):
        resolve_kernel_name(KingConfig(kernel="cuda", device="cpu"))
    with pytest.raises(InvalidArgumentError, match="Unknown kernel"):
        resolve_kernel_name(KingConfig(kernel="pallas", device="cpu"))


def test_engine_fit_names_the_split_factor():
    sub = Submatrix.create(32_768, 1, 0)
    cfg = KingConfig(device="cpu")
    check_engine_fit(32_768, 3128, sub, cfg, 1, bytes_limit=4 << 30)
    # Planes 782 MiB + sweep buffers 496 MiB (the 240 MiB result buffer and
    # 256 MiB of step transients) leave 404 MiB for planes: split 4's
    # off-diagonal shard stores two blocks of 8,192 rows.
    with pytest.raises(InvalidArgumentError, match="split_factor to at least 4"):
        check_engine_fit(32_768, 3128, sub, cfg, 1, bytes_limit=900 << 20)
    with pytest.raises(InvalidArgumentError, match="no --split_factor"):
        check_engine_fit(32_768, 3128, sub, cfg, 1, bytes_limit=100 << 20)


class _HeldEvent:
    """A count copy that lands only when waited on: it fills its host tensor
    in ``synchronize``, and ``query`` stays false until then."""

    def __init__(self, hits, host, value):
        self.hits, self.host, self.value = hits, host, value
        self.index = hits.taken

    def query(self):
        return False

    def synchronize(self):
        self.host.fill_(self.value)
        self.hits.waited.append((self.hits.taken, self.index))


class _HeldHitBuffer(HitBuffer):
    """A HitBuffer whose snapshots hold their value back until waited on, so
    a sweep that only polled them would never see one."""

    def __init__(self, capacity, device):
        super().__init__(capacity, device)
        self.taken, self.waited = 0, []

    def snapshot(self):
        self.taken += 1
        host = torch.zeros((), dtype=torch.int64)
        self._snapshots.append((host, _HeldEvent(self, host, int(self.count))))


@pytest.fixture
def held(monkeypatch):
    """The engine sweeps into _HeldHitBuffer with a count copy every 2
    steps; returns the buffers made and the steps run."""
    buffers, steps = [], []

    def make(capacity, device):
        buffers.append(_HeldHitBuffer(capacity, device))
        return buffers[-1]

    def counted(*args, **kw):
        steps.append(args[2:4])
        return emit_hits(*args, **kw)

    emit_hits = torch_king.emit_hits
    monkeypatch.setattr(torch_king, "HitBuffer", make)
    monkeypatch.setattr(torch_king, "emit_hits", counted)
    monkeypatch.setattr(torch_king, "LIMIT_CHECK_STEPS", 2)
    return buffers, steps


def test_sweep_waits_for_the_copy_a_window_back(genotypes, held):
    """Once more than LIMIT_CHECK_WINDOW copies are pending, the sweep waits
    for the oldest: the k-th wait is for copy k, made when copy k + 4 was
    taken.  The results are those of a sweep without the held copies."""
    buffers, steps = held
    cfg = KingConfig(panel=8, device="cpu", kin_threshold=0.05)
    engine = KingEngine.from_genotypes(genotypes, cfg)
    got = engine.run()
    num_steps = len(engine._panel_pair_params())
    assert len(steps) == num_steps == 21 and len(buffers) == 1
    window = torch_king.LIMIT_CHECK_WINDOW
    taken = num_steps // 2
    assert buffers[0].waited == [(k + window, k) for k in range(1, taken - window + 1)]
    assert buffers[0].waits == taken - window
    ref = KingEngine.from_genotypes(genotypes, cfg).run()
    assert len(ref) > 0
    _assert_same(got, ref)


def test_overflowing_sweep_stops_within_the_window(genotypes, held):
    """A keep-all sweep whose first count copy already passes max_results
    raises the JAX engine's error after (LIMIT_CHECK_WINDOW + 1) x 2 steps of
    its 21, having waited for that first copy only."""
    buffers, steps = held
    common = dict(panel=8, kin_threshold=-2.0, max_results=50)
    with pytest.raises(JaxResourceExhausted) as ref:
        JaxEngine.from_genotypes(genotypes, JaxConfig(
            **common, kernel="matmul", site_chunk_words=16, sweep_batch=2)).run()
    engine = KingEngine.from_genotypes(genotypes, KingConfig(**common, device="cpu"))
    with pytest.raises(ResourceExhaustedError) as got:
        engine.run()
    assert str(got.value) == str(ref.value)
    window = torch_king.LIMIT_CHECK_WINDOW
    assert len(steps) == (window + 1) * 2 < len(engine._panel_pair_params())
    assert buffers[0].waited == [(window + 1, 1)]
