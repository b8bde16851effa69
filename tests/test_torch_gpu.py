"""The CUDA count kernel against its plain PyTorch versions and its
AND + popcount yardstick, and the emit kernel against its plain version, on
the card.

Marked ``gpu``: a CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is false.  This file imports no jax, so it also
runs on a GPU machine without the JAX package's dependencies::

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuking_tpu_torch.models import king as king_model
from cuking_tpu_torch.ops import king_cuda, king_emit
from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu_torch.ops.compaction import HitBuffer
from cuking_tpu_torch.ops.king_cuda import (
    panel_counts_cuda,
    panel_counts_cuda_indexed,
    panel_counts_five_block,
    panel_counts_popc_indexed,
)
from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
from cuking_tpu_torch.ops.king_emit import emit_hits, emit_hits_plain
from cuking_tpu_torch.ops.king_math import KingCounts, king_from_counts
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.parallel import ring
from cuking_tpu_torch.parallel.ring import (
    RingMesh,
    all_pairs_sharded,
    ring_output_to_resultset,
)
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils.hbm import ring_shard_bytes
from cuking_tpu_torch.utils.status import ResourceExhaustedError
from cuking_tpu_torch.utils.synthetic import (
    edge_planes,
    random_counters,
    random_genotypes,
    random_planes,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("sites,i_off,j_off,panel,panel_j,tri", [
    (100_000, 100, 1100, 1024, 1024, 0),
    (3_100, 17, 1100, 1000, 700, 0),
    (3_100, 256, 256, 1024, 1024, 1),
])
def test_cuda_kernel_matches_plain_version(cuda_device, sites, i_off, j_off,
                                           panel, panel_j, tri):
    rng = np.random.default_rng(sites)
    layout = PlaneLayout.create(sites)
    planes_np = rng.integers(0, 1 << 32, size=(2, 2200, layout.words),
                             dtype=np.uint32)
    planes = torch.from_numpy(planes_np.view(np.int32)).to(cuda_device)
    got = panel_counts_cuda_indexed(planes, i_off, j_off, tri, panel,
                                    panel_j=panel_j)
    exp = panel_counts_matmul(planes[:, i_off:i_off + panel],
                              planes[:, j_off:j_off + panel_j])
    torch.cuda.synchronize()
    for name, g, e in zip(got._fields, got, exp):
        if tri:  # only pairs with i < j are defined
            keep = torch.ones_like(g, dtype=torch.bool).triu(1)
            g, e = g[keep], e[keep]
        assert torch.equal(g, e), name


@pytest.mark.gpu
@pytest.mark.parametrize("sites,n,tri", [
    (100_000, 320, 0), (128, 300, 0), (128, 300, 1), (1_000_000, 130, 0),
])
def test_cuda_kernel_matches_five_block_and_popc_on_edge_rows(cuda_device, sites, n, tri):
    """Edge rows at 100,000 sites, at W = 4 (128 sites) and at 1,000,000
    sites: the kernel equals the five-block plain version, and so does the
    AND + popcount kernel; each launch is counted once, on its own counter."""
    layout = PlaneLayout.create(sites)
    planes = torch.from_numpy(
        edge_planes(n, layout, np.random.default_rng(sites)).view(np.int32)
    ).to(cuda_device)
    before = (king_cuda.launches, king_cuda.popc_launches)
    got = {"kernel": panel_counts_cuda_indexed(planes, 0, 0, tri, n),
           "popc": panel_counts_popc_indexed(planes, 0, 0, tri, n)}
    assert (king_cuda.launches, king_cuda.popc_launches) == (before[0] + 1, before[1] + 1)
    exp = panel_counts_five_block(planes, planes)
    torch.cuda.synchronize()
    keep = torch.ones((n, n), dtype=torch.bool, device=cuda_device).triu(1 if tri else -n)
    for who, counts in got.items():
        for name, g, e in zip(counts._fields, counts, exp):
            assert torch.equal(g[keep], e[keep]), (who, name)


@pytest.mark.gpu
def test_every_card_launches_the_kernel_and_runs_the_ring(cuda_device):
    """The kernel on every visible card, in one process and in both orders
    of first use, against the five-block plain version on that card; then
    the ring with one position per card (the ``--use_mesh`` default)
    against the engine.  On a one-card machine this is cuda:0 alone."""
    count = torch.cuda.device_count()
    layout = PlaneLayout.create(3_100)
    planes_np = edge_planes(260, layout, np.random.default_rng(count))
    for k in [*range(count), *reversed(range(count))]:
        planes = torch.from_numpy(planes_np.view(np.int32)).to(f"cuda:{k}")
        got = panel_counts_cuda_indexed(planes, 0, 130, 0, 130)
        exp = panel_counts_five_block(planes[:, :130], planes[:, 130:])
        for name, g, e in zip(got._fields, got, exp):
            assert g.device == planes.device, (k, name)
            assert torch.equal(g, e), (k, name)
        hits = {who: HitBuffer(1 << 15, planes.device) for who in ("kernel", "plain")}
        emit_hits(got, hits["kernel"], 0, 130, 130, 260, -2.0, True, True)
        emit_hits_plain(got, hits["plain"], 0, 130, 130, 260, -2.0, True, True)
        assert _sorted_rows(hits["kernel"]) == _sorted_rows(hits["plain"]), k
    g = random_genotypes(300, 3_000, missing_rate=0.05, seed=count, num_related_pairs=4)
    before = king_cuda.launches, king_emit.emit_launches
    out = all_pairs_sharded(
        pack_genotypes(g, PlaneLayout.create(3_000)), 300,
        RingMesh([f"cuda:{k}" for k in range(count)]), panel_counts_cuda,
        kin_threshold=-2.0, capacity_per_device=1 << 16,
        indexed_kernel=panel_counts_cuda_indexed)
    assert king_cuda.launches > before[0] and king_emit.emit_launches > before[1]
    got = ring_output_to_resultset(out)
    ref = KingEngine.from_genotypes(
        g, KingConfig(kernel="cuda", device="cuda", panel=128, kin_threshold=-2.0)).run()
    assert len(got) == len(ref) > 0
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))


def _sorted_rows(hits: HitBuffer) -> list:
    total = int(hits.count)
    return sorted(map(tuple, hits.rows(total).T.tolist()))


TIES = ((2, 20), (3, 25), (4, 28))


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["count kernel", "random counters"])
@pytest.mark.parametrize("strict,sym", [(True, False), (True, True), (False, True), (False, False)])
@pytest.mark.parametrize("threshold", ["tie", -2.0])
@pytest.mark.parametrize("capacity", [1 << 20, 777])
def test_emit_kernel_matches_plain_version(cuda_device, source, strict, sym, threshold,
                                           capacity):
    """The emit kernel and its plain version on the same counters: the same
    exact count and the same rows (kin bits included); past ``capacity``
    the kernel keeps ``capacity`` of the plain version's rows.  The counters
    come from the count kernel (a 300 x 450 block of 3,100 sites, limits
    inside it) or are random, with NaN/-inf rows and three pairs whose kin
    equals the threshold."""
    rng = np.random.default_rng(7)
    if source == "count kernel":
        planes = torch.from_numpy(
            random_planes(2000, PlaneLayout.create(3_100), rng).view(np.int32)).to(cuda_device)
        counts = panel_counts_cuda_indexed(planes, 0, 1000, 0, 300, panel_j=450)
        counts = KingCounts(*(c.clone() for c in counts))  # separate: stacked
        gi, gj, il, jl = 990, 1000, 1280, 1430
    else:
        counts = KingCounts(*torch.from_numpy(
            random_counters(300, 450, rng, TIES)).to(cuda_device).unbind(0))
        gi, gj, il, jl = 0, 0, 300, 450
    if threshold == "tie":
        threshold = float(king_from_counts(counts).kin[TIES[0]])
    got, ref = HitBuffer(capacity, cuda_device), HitBuffer(1 << 20, cuda_device)
    before = king_emit.emit_launches
    emit_hits(counts, got, gi, gj, il, jl, threshold, strict, sym)
    assert king_emit.emit_launches == before + 1
    emit_hits_plain(counts, ref, gi, gj, il, jl, threshold, strict, sym)
    total = int(got.count)
    assert total == int(ref.count) > 0
    want = _sorted_rows(ref)
    if total <= capacity:
        assert _sorted_rows(got) == want
    else:
        kept = _sorted_rows(got)
        assert len(kept) == capacity and set(kept) <= set(want)


@pytest.mark.gpu
def test_engine_sweep_never_waits_for_the_device(cuda_device, monkeypatch):
    """The engine's step loop under ``set_sync_debug_mode("error")``, with
    a count copy every 2 steps: no call in it waits for the device but its
    deliberate waits on the events of the count copies a window back, and
    the hits are those of ``run()``."""
    g = random_genotypes(600, 3_000, missing_rate=0.05, seed=3, num_related_pairs=4)
    engine = KingEngine.from_genotypes(g, KingConfig(kernel="cuda", device="cuda", panel=128))
    rs = engine.run()
    monkeypatch.setattr(king_model, "LIMIT_CHECK_STEPS", 2)
    before = king_cuda.launches, king_emit.emit_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hits = engine.sweep(1 << 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps = len(engine._panel_pair_params())
    assert (king_cuda.launches - before[0], king_emit.emit_launches - before[1]) == (steps,) * 2
    assert int(hits.count) == len(rs) >= 4
    assert hits.waits == steps // 2 - king_model.LIMIT_CHECK_WINDOW > 0


@pytest.mark.gpu
def test_overflowing_sweep_stops_early_on_the_card(cuda_device):
    """A keep-all sweep of 28 panels (406 steps) passes the default
    max_results within its first 64 steps; it raises the JAX engine's error
    with at most (LIMIT_CHECK_WINDOW + 1) x 64 steps queued, long before its
    last."""
    g = random_genotypes(28 * 1024, 1_000, missing_rate=0.05, seed=28)
    engine = KingEngine.from_genotypes(g, KingConfig(kernel="cuda", device="cuda",
                                                     kin_threshold=-2.0))
    steps = len(engine._panel_pair_params())
    assert steps == 406
    engine.planes_dev
    before = king_emit.emit_launches
    with pytest.raises(ResourceExhaustedError, match="--max_results"):
        engine.run()
    queued = king_emit.emit_launches - before
    bound = (king_model.LIMIT_CHECK_WINDOW + 1) * king_model.LIMIT_CHECK_STEPS
    assert 0 < queued <= bound < steps


@pytest.mark.gpu
def test_ring_retry_holds_one_set_of_hit_buffers(cuda_device):
    """A keep-all ring of 2 positions on the card overflows 2^21 slots per
    position and re-runs at 2^22: its peak device memory stays inside
    check_ring_fit's model and below the planes plus both runs' hit buffers,
    since the first run's are freed before the retry makes its own; the
    rows equal the engine's."""
    n, sites, first = 4096, 3_000, 1 << 21
    layout = PlaneLayout.create(sites)
    planes = random_planes(n, layout, np.random.default_rng(21))
    mesh = RingMesh([cuda_device] * 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = all_pairs_sharded(planes, n, mesh, panel_counts_cuda, kin_threshold=-2.0,
                            capacity_per_device=first,
                            indexed_kernel=panel_counts_cuda_indexed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert out.capacity_per_device == 2 * first
    model = ring_shard_bytes(n, n, True, layout.words, 1024, 1, 2, first,
                             king_model.DEFAULT_MAX_RESULTS, positions_per_device=2)
    both_sets = 2 * 24 * (first + out.capacity_per_device)
    assert peak <= model
    assert peak < planes.nbytes + both_sets
    got = ring_output_to_resultset(out)
    del out
    ref = KingEngine(_storage(planes, layout), KingConfig(
        kernel="cuda", device="cuda", kin_threshold=-2.0)).run()
    assert len(got) == len(ref) > 2 * first
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))


def _storage(planes, layout):
    """A split-1 PanelStorage holding ``planes`` ([2, n, W] uint32)."""
    n = planes.shape[1]
    storage = PanelStorage(layout, Submatrix.create(n, 1, 0), 1024)
    storage.planes[:, :n] = planes
    storage.mark_mutated()
    return storage


@pytest.mark.gpu
def test_cuda_sliced_entry_counts_its_launch(cuda_device):
    rng = np.random.default_rng(5)
    planes = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(2, 300, 100), dtype=np.uint32).view(np.int32)
    ).to(cuda_device)
    pi, pj = planes[:, :130].contiguous(), planes[:, 130:].contiguous()
    before = king_cuda.launches
    got = panel_counts_cuda(pi, pj)
    assert king_cuda.launches == before + 1
    exp = panel_counts_matmul(pi, pj)
    for name, g, e in zip(got._fields, got, exp):
        assert torch.equal(g, e), name


@pytest.mark.gpu
@pytest.mark.parametrize("positions,sub_panel", [(3, 64), (4, 64), (4, None)])
def test_ring_on_one_card_equals_the_engine(cuda_device, positions, sub_panel):
    """The ring with every position on cuda:0 (odd D; even D with sub-tiled
    and with single-tile wrap steps, the latter reading the visitor at row
    offset p1) returns the cuda engine's keep-all results exactly."""
    g = random_genotypes(300, 3_000, missing_rate=0.05, seed=positions,
                         num_related_pairs=4)
    layout = PlaneLayout.create(3_000)
    before = king_cuda.launches
    out = all_pairs_sharded(
        pack_genotypes(g, layout), 300, RingMesh([cuda_device] * positions),
        panel_counts_cuda, kin_threshold=-2.0, capacity_per_device=1 << 16,
        sub_panel=sub_panel, indexed_kernel=panel_counts_cuda_indexed)
    assert king_cuda.launches > before
    got = ring_output_to_resultset(out)
    ref = KingEngine.from_genotypes(
        g, KingConfig(kernel="cuda", device="cuda", panel=128, kin_threshold=-2.0)).run()
    assert len(got) == len(ref) > 0
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))


@pytest.mark.gpu
def test_rendered_batch_tasks_run_on_the_card(cuda_device, tmp_path):
    """The Batch job for split 2, its three task commands run under
    ``/bin/sh -c`` from the repository root as the container runs them:
    each launches the kernel (its trace shows it), and the merged partitions
    equal the cuda engine's results."""
    import contextlib
    import io

    from cuking_tpu_torch.cloud import batch_submit
    from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.io.writer import read_results_table

    g = random_genotypes(300, 3_000, missing_rate=0.05, seed=9, num_related_pairs=4)
    inp, out, traces = (str(tmp_path / d) for d in ("in.parquet", "out", "traces"))
    metadata = write_synthetic_input(Storage(), inp, g)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert batch_submit.main([
            "--input-uri", inp, "--output-uri", out, "--kin-threshold=-2.0",
            "--split-factor", "2", "--docker-image", "img", "--render-only",
            f"--cuking-arg=--profile_dir={traces}", "--cuking-arg=--quiet"]) == 0
    command = json.loads(buf.getvalue())["taskGroups"][0]["taskSpec"]["runnables"][0][
        "container"]["commands"][1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join([os.path.dirname(sys.executable), os.environ.get("PATH", "")])
    for k in range(3):
        proc = subprocess.run(["/bin/sh", "-c", command], cwd=repo,
                              env=dict(os.environ, BATCH_TASK_INDEX=str(k), PATH=path),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        with open(os.path.join(traces, f"trace-part-{k:05d}.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "kernel" and "king_counts_wgmma_kernel" in e["name"]
                   for e in events), k

    table = read_results_table(Storage(), out)
    index = {s: k for k, s in enumerate(metadata.samples)}
    got = sorted(zip([index[s] for s in table.column("i").to_pylist()],
                     [index[s] for s in table.column("j").to_pylist()],
                     np.asarray(table.column("kin").to_numpy(), np.float32)
                     .view(np.uint32).tolist(),
                     *(table.column(c).to_pylist() for c in ("ibs0", "ibs1", "ibs2"))))
    ref = KingEngine.from_genotypes(
        g, KingConfig(kernel="cuda", device="cuda", panel=128, kin_threshold=-2.0)).run()
    exp = sorted(zip(ref.i_idx.tolist(), ref.j_idx.tolist(),
                     ref.kin.view(np.uint32).tolist(), ref.ibs0.tolist(),
                     ref.ibs1.tolist(), ref.ibs2.tolist()))
    assert len(got) == len(exp) > 0
    assert got == exp


@pytest.mark.gpu
def test_side_stream_copy_runs_under_the_compute_stream(cuda_device):
    """The ring's copy between cards, forced onto one card, queues behind
    neither card's compute: a cell-A-sized block (16,384 rows x 3,128
    words) is delivered while a spin kernel of ~1 s still holds the compute
    stream, and it equals the source.  A first copy makes the side streams
    and the receive block, as the ring's first rotation does (a process's
    first streams from PyTorch's pool were seen to wait for running
    kernels); the timed one reuses them, as every later rotation does."""
    block = torch.randint(-2**31, 2**31 - 1, (2, 16384, 3128), dtype=torch.int32,
                          device=cuda_device)
    streams = ring._SideStreams([block])
    first, _ = streams.copy(block, None, block.device)
    del first
    streams.release()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    spin_done = torch.cuda.current_stream().record_event()
    out, delivered = streams.copy(block, None, block.device)
    delivered.synchronize()
    assert not spin_done.query(), "the copy waited for the compute stream"
    streams.join()
    torch.cuda.synchronize()
    assert out.device == block.device and torch.equal(out, block)


def _same_rows(got, ref) -> None:
    assert len(got) == len(ref) > 0
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("positions", [3, 4])
def test_ring_step_loop_never_waits_for_the_device(cuda_device, monkeypatch, positions):
    """The ring's step loop with every position on cuda:0, rotations
    included, under ``set_sync_debug_mode("error")`` until the one read of
    the counts at its end; the rows equal the cuda engine's."""
    g = random_genotypes(600, 3_000, missing_rate=0.05, seed=positions, num_related_pairs=4)
    finish = ring._finish

    def finish_checked(hits, mesh):
        torch.cuda.set_sync_debug_mode("default")
        return finish(hits, mesh)

    monkeypatch.setattr(ring, "_finish", finish_checked)
    mesh = RingMesh([cuda_device] * positions)
    blocks, _ = ring._pad_and_shard(pack_genotypes(g, PlaneLayout.create(3_000)), 600, mesh, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ring.all_pairs_presharded(
            blocks, 600, mesh, panel_counts_cuda, kin_threshold=-2.0,
            capacity_per_device=1 << 18, sub_panel=64,
            indexed_kernel=panel_counts_cuda_indexed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = KingEngine.from_genotypes(
        g, KingConfig(kernel="cuda", device="cuda", panel=128, kin_threshold=-2.0)).run()
    _same_rows(ring_output_to_resultset(out), ref)


@pytest.mark.gpu
def test_ring_over_cards_stays_inside_the_ring_model(cuda_device):
    """With two cards or more, a ring of one position per card at 2,048
    rows per card x 100,000 sites returns the cuda engine's rows, and each
    card's peak device memory stays inside check_ring_fit's model."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards or more")
    n, sites = 2048 * cards, 100_000
    layout = PlaneLayout.create(sites)
    g = random_genotypes(n, sites, missing_rate=0.05, seed=cards, num_related_pairs=4)
    planes = pack_genotypes(g, layout)
    base = []
    for k in range(cards):
        torch.cuda.synchronize(k)
        torch.cuda.reset_peak_memory_stats(k)
        base.append(torch.cuda.memory_allocated(k))
    out = all_pairs_sharded(planes, n, RingMesh([f"cuda:{k}" for k in range(cards)]),
                            panel_counts_cuda, kin_threshold=0.0884,
                            capacity_per_device=1 << 16,
                            indexed_kernel=panel_counts_cuda_indexed)
    model = ring_shard_bytes(n, n, True, layout.words, 1024, 1, cards, 1 << 16,
                             king_model.DEFAULT_MAX_RESULTS)
    for k in range(cards):
        torch.cuda.synchronize(k)
        peak = torch.cuda.max_memory_allocated(k) - base[k]
        assert peak <= model, (k, peak, model)
    ref = KingEngine.from_genotypes(
        g, KingConfig(kernel="cuda", device="cuda", kin_threshold=0.0884)).run()
    _same_rows(ring_output_to_resultset(out), ref)


@pytest.fixture(scope="module")
def store_1m():
    """36,864 x 1,000,000 planes on the card, 2.30e9 words (9.2 GB): the
    hom rows from 31,854 on lie past word 2^31.  Random words drawn on the
    card; the module's last tests use it, so it is freed at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    words = PlaneLayout.create(1_000_000).words
    gen = torch.Generator(device="cuda").manual_seed(36_864)
    planes = torch.randint(-2**31, 2**31 - 1, (2, 36_864, words), generator=gen,
                           dtype=torch.int32, device="cuda")
    assert planes.numel() > 2**31 and 36_864 * words + 31_854 * words >= 2**31
    yield planes
    del planes
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("i_off,tri", [(35_840, 1), (0, 0)])
def test_kernels_past_word_2_31_at_1m_sites(store_1m, i_off, tri):
    """The last diagonal pair and the (first, last) pair of the 1M-site
    store through the indexed entry: the six counters equal the five-block
    plain version and the AND + popcount yardstick, and the emit kernel on
    them equals emit_hits_plain, keep-all and at the counters' median kin."""
    planes, j_off = store_1m, 35_840
    got = panel_counts_cuda_indexed(planes, i_off, j_off, tri, 1024)
    five = panel_counts_five_block(planes[:, i_off:i_off + 1024], planes[:, j_off:j_off + 1024])
    popc = panel_counts_popc_indexed(planes, i_off, j_off, tri, 1024)
    keep = torch.ones((1024, 1024), dtype=torch.bool, device=planes.device)
    if tri:
        keep = keep.triu(1)
    for name, g, f, p in zip(got._fields, got, five, popc):
        assert torch.equal(g[keep], f[keep]), name
        assert torch.equal(g[keep], p[keep]), name
    median = float(king_from_counts(got).kin[keep].median())
    for threshold in (-2.0, median):
        args = (i_off, j_off, i_off + 1024, j_off + 1024, threshold, True, False)
        hits, ref = HitBuffer(1 << 20, planes.device), HitBuffer(1 << 20, planes.device)
        emit_hits(got, hits, *args)
        emit_hits_plain(got, ref, *args)
        assert int(hits.count) == int(ref.count) > 0
        assert _sorted_rows(hits) == _sorted_rows(ref)
