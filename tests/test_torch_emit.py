"""The emit step (cuking_tpu_torch/ops/king_emit.py) against the JAX
package's per-step epilogue, mask and ``accumulate_hits``: on CPU tensors
``emit_hits`` runs the emit kernel's plain version.  Counters are seeded
numpy arrays with zero-het rows (NaN and -inf kin), kin equal to the
threshold, limits inside the block, ``strict``/``sym`` and running counts
past capacity; rows are compared sorted, kin as uint32 bits.  Then the
engine's lagged ``max_results`` check against the JAX engine's error."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuking_tpu.models.king import KingConfig as JaxConfig
from cuking_tpu.models.king import KingEngine as JaxEngine
from cuking_tpu.ops import king_math as jax_math
from cuking_tpu.ops.compaction import accumulate_hits, empty_result_buffers
from cuking_tpu.utils.status import ResourceExhaustedError as JaxResourceExhausted
from cuking_tpu_torch.models import king as torch_king
from cuking_tpu_torch.models.king import KingConfig, KingEngine
from cuking_tpu_torch.ops import king_emit
from cuking_tpu_torch.ops.compaction import HitBuffer
from cuking_tpu_torch.ops.king_emit import _counter_block, emit_hits
from cuking_tpu_torch.ops.king_math import KingCounts
from cuking_tpu_torch.utils.status import InvalidArgumentError, ResourceExhaustedError
from cuking_tpu_torch.utils.synthetic import random_counters, random_genotypes


def jax_kin(counters: np.ndarray) -> np.ndarray:
    return np.asarray(jax_math.king_from_counts(
        jax_math.KingCounts(*(jnp.asarray(c) for c in counters))).kin)


def jax_emit(bufs, running, counters, gi_base, gj_base, i_limit, j_limit,
             threshold, strict, sym, capacity):
    """The JAX sweep's step after its count kernel: ``king_from_counts``,
    the mask over global indices, and ``accumulate_hits``."""
    res = jax_math.king_from_counts(
        jax_math.KingCounts(*(jnp.asarray(c) for c in counters)))
    ni, nj = counters.shape[1:]
    gi = jnp.broadcast_to(gi_base + jnp.arange(ni, dtype=jnp.int32)[:, None], (ni, nj))
    gj = jnp.broadcast_to(gj_base + jnp.arange(nj, dtype=jnp.int32)[None, :], (ni, nj))
    mask = (gi < i_limit) & (gj < j_limit) & (res.kin > jnp.float32(threshold))
    if strict:
        mask = mask & (gi < gj)
    if sym:
        gi, gj = jnp.minimum(gi, gj), jnp.maximum(gi, gj)
    fields = (gi, gj, res.kin, res.ibs0, res.ibs1, res.ibs2)
    return accumulate_hits(bufs, running, mask, fields, capacity)


def sorted_rows(rows: np.ndarray) -> list:
    """[6, n] int32 rows as a sorted list of tuples (kin as its bits)."""
    return sorted(map(tuple, rows.T.tolist()))


def jax_rows(bufs, total: int, capacity: int) -> np.ndarray:
    n = min(total, capacity)
    return np.stack([np.asarray(bufs[0])[:n], np.asarray(bufs[1])[:n],
                     np.asarray(bufs[2])[:n].view(np.int32),
                     *(np.asarray(b)[:n] for b in bufs[3:])])


# Each case: the blocks of one sweep (shape, gi_base, gj_base, i_limit,
# j_limit), strict, sym.
STEPS = {
    "engine diagonal and off-diagonal pairs, limits inside the block": (
        [((37, 45), 0, 0, 33, 33), ((37, 45), 0, 37, 33, 80), ((37, 45), 37, 37, 70, 70)],
        True, False),
    "ring sub-tile across the diagonal, strict and sym": (
        [((40, 40), 100, 90, 140, 140), ((40, 40), 90, 100, 140, 125)], True, True),
    "ring off-diagonal sub-tiles, sym only": (
        [((32, 48), 200, 20, 230, 60), ((32, 48), 20, 200, 50, 240)], False, True),
    "rectangular ring, neither": ([((29, 31), 0, 64, 25, 90)], False, False),
}


@pytest.mark.parametrize("threshold", ["tie", -2.0, 0.0884])
@pytest.mark.parametrize("case", list(STEPS))
def test_plain_emit_matches_jax_accumulate_hits(case, threshold):
    steps, strict, sym = STEPS[case]
    rng = np.random.default_rng(len(case))
    ties = ((2, 20), (3, 25), (4, 28))  # candidates in every case's first block
    blocks = [random_counters(*shape, rng, ties) for shape, *_ in steps]
    if threshold == "tie":
        # The three pairs share one finite kin, the threshold: the strict >
        # must leave all three out.
        kin = jax_kin(blocks[0])
        threshold = float(kin[ties[0]])
        assert np.isfinite(threshold) and (kin == np.float32(threshold)).sum() >= 3
    for capacity in (1 << 14, 5):
        hits = HitBuffer(capacity, "cpu")
        bufs, running = empty_result_buffers(capacity), jnp.int32(0)
        for counters, (_, gi_base, gj_base, i_limit, j_limit) in zip(blocks, steps):
            emit_hits(KingCounts(*torch.from_numpy(counters).unbind(0)), hits,
                      gi_base, gj_base, i_limit, j_limit, threshold, strict, sym)
            bufs, running = jax_emit(bufs, running, counters, gi_base, gj_base, i_limit,
                                     j_limit, threshold, strict, sym, capacity)
        total = int(hits.count)
        assert total == int(running)
        got, ref = sorted_rows(hits.rows(total)), sorted_rows(jax_rows(bufs, total, capacity))
        if capacity > total:
            assert total > 0
            assert got == ref
        else:
            # Past capacity both keep `capacity` hits, in their own orders.
            assert len(got) == len(ref) == capacity


def test_nan_and_neg_inf_never_pass():
    """Zero-het pairs give NaN or -inf kin, and no threshold lets them through."""
    counters = random_counters(8, 8, np.random.default_rng(3))
    kin = jax_kin(counters)
    assert np.isnan(kin[1, 2]) and np.isneginf(kin).any()
    hits = HitBuffer(64, "cpu")
    emit_hits(KingCounts(*torch.from_numpy(counters).unbind(0)), hits, 0, 0, 8, 8,
              float(-np.inf), False, False)
    finite = int(np.isfinite(kin).sum())
    assert int(hits.count) == finite < 64


def test_counter_block_is_the_kernels_output_without_a_copy():
    """Counters that are consecutive planes of one [6, ni, nj] tensor (the
    count kernel's output) are passed as that tensor; separate ones are
    stacked."""
    out = torch.arange(6 * 5 * 7, dtype=torch.int32).reshape(6, 5, 7)
    block = _counter_block(KingCounts(*out.unbind(0)))
    assert block.data_ptr() == out.data_ptr() and torch.equal(block, out)
    loose = KingCounts(*(c.clone() for c in out.unbind(0)))
    stacked = _counter_block(loose)
    assert stacked.data_ptr() != out.data_ptr() and torch.equal(stacked, out)
    swapped = KingCounts(*reversed(out.unbind(0)))
    assert torch.equal(_counter_block(swapped), out.flip(0))


def test_emit_checks_its_inputs_and_does_not_fall_back_off_the_cpu():
    counts = KingCounts(*torch.zeros((6, 4, 4), dtype=torch.int32).unbind(0))
    with pytest.raises(InvalidArgumentError, match="counter het_j"):
        emit_hits(counts._replace(het_j=torch.zeros((4, 3), dtype=torch.int32)),
                  HitBuffer(8, "cpu"), 0, 0, 4, 4, 0.0, True, False)
    with pytest.raises(InvalidArgumentError, match="counter both_het"):
        emit_hits(KingCounts(*torch.zeros((6, 4, 4)).unbind(0)),
                  HitBuffer(8, "cpu"), 0, 0, 4, 4, 0.0, True, False)
    with pytest.raises(InvalidArgumentError, match="hit buffer is on meta"):
        emit_hits(counts, HitBuffer(8, "meta"), 0, 0, 4, 4, 0.0, True, False)
    meta = KingCounts(*torch.zeros((6, 4, 4), dtype=torch.int32, device="meta").unbind(0))
    before = king_emit.emit_launches
    with pytest.raises(InvalidArgumentError, match="runs on CUDA"):
        emit_hits(meta, HitBuffer(8, "meta"), 0, 0, 4, 4, 0.0, True, False)
    assert king_emit.emit_launches == before


def test_snapshots_of_the_count():
    hits = HitBuffer(4, "cpu")
    assert hits.pending == 0
    hits.count += 3
    hits.snapshot()
    hits.count += 4
    hits.snapshot()
    assert hits.pending == 2
    assert hits.wait_oldest() == 3 and hits.wait_oldest() == 7
    assert hits.pending == 0 and hits.waits == 2
    assert int(hits.count) == 7


N = 48


def test_lagged_max_results_check_stops_the_sweep_like_jax(monkeypatch):
    """With a count copy every 2 steps, a keep-all sweep of 21 steps raises
    ResourceExhausted with the JAX engine's message once the copy it waits
    for, ``LIMIT_CHECK_WINDOW`` copies behind the newest, shows more than
    max_results, before its last step."""
    g = random_genotypes(N, 300, missing_rate=0.05, seed=23)
    common = dict(panel=8, kin_threshold=-2.0, max_results=100)
    with pytest.raises(JaxResourceExhausted) as ref:
        JaxEngine.from_genotypes(g, JaxConfig(**common, kernel="matmul",
                                              site_chunk_words=16, sweep_batch=2)).run()
    steps = []

    def counted(*args, **kw):
        steps.append(args[2:4])
        return emit_hits(*args, **kw)

    monkeypatch.setattr(torch_king, "LIMIT_CHECK_STEPS", 2)
    monkeypatch.setattr(torch_king, "emit_hits", counted)
    engine = KingEngine.from_genotypes(g, KingConfig(**common, device="cpu"))
    with pytest.raises(ResourceExhaustedError) as got:
        engine.run()
    assert str(got.value) == str(ref.value)
    # 28 + 64 = 92 hits at the copy after step 2, 220 at the one after step 4;
    # the sweep waits for that one when the copy after step 12 is pending.
    assert len(steps) == 12 < len(engine._panel_pair_params()) == 21


def test_re_run_holds_every_pair_after_overflow():
    """The sweep's total passes its 5 slots; the re-run at 2,048 slots (the
    pow2 bucket of 1,128) returns every pair, equal to a roomy run."""
    g = random_genotypes(N, 300, missing_rate=0.05, seed=24)
    small = KingEngine.from_genotypes(g, KingConfig(panel=16, kin_threshold=-2.0,
                                                    result_capacity=5, device="cpu"))
    hits = small.sweep(5)
    assert int(hits.count) == N * (N - 1) // 2 and hits.capacity == 5
    roomy = KingEngine.from_genotypes(g, KingConfig(panel=16, kin_threshold=-2.0,
                                                    device="cpu")).run()
    got = small.run()
    assert len(got) == len(roomy) == N * (N - 1) // 2
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(roomy, f)), f
    assert np.array_equal(got.kin.view(np.uint32), roomy.kin.view(np.uint32))
