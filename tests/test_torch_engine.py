"""The port's KingEngine (device cpu: the plain count path) against the JAX
KingEngine running its Pallas kernel in interpret mode (as
tests/test_engine.py runs it): identical ResultSets, kin compared as uint32
bits, for every shard of split factors 1 and 2 at two thresholds, through
the result buffer's overflow re-run, and with the same max_results overflow
error."""

import io

import numpy as np
import pytest

from cuking_tpu.models.king import KingConfig as JaxConfig
from cuking_tpu.models.king import KingEngine as JaxEngine
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix
from cuking_tpu.utils.status import ResourceExhaustedError as JaxResourceExhausted
from cuking_tpu.utils.stopwatch import StageLogger as JaxStageLogger
from cuking_tpu_torch.models.king import KingConfig, KingEngine, resolve_kernel_name
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils.hbm import check_engine_fit
from cuking_tpu_torch.utils.status import InvalidArgumentError, ResourceExhaustedError
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
