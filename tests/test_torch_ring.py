"""The port's ring (cuking_tpu_torch/parallel/ring.py) against the JAX
package's ring on conftest's 8-device CPU mesh: the schedule algebra, and
identical ResultSets (kin as uint32 bits, IBS exact) for even and odd D,
ragged N, the wrap split inside one sub-tile and merged Submatrix rings.
Sub-panels and the overflow paths are held against the JAX package's numpy
oracle and its overflow messages, which keeps the file's JAX compiles few.
The port's positions are ``cpu`` repeated, so the sub-tiles run the plain
versions of the count kernel."""

import weakref
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from cuking_tpu.ops.bitset import PlaneLayout as JaxLayout
from cuking_tpu.ops.bitset import pack_genotypes as jax_pack
from cuking_tpu.ops.king_mm import panel_counts_matmul as jax_matmul
from cuking_tpu.ops.oracle import oracle_king
from cuking_tpu.parallel import ring as jring
from cuking_tpu.utils.status import ResourceExhaustedError as JaxResourceExhausted
from cuking_tpu_torch.models.king import PanelStorage, ResultSet
from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.parallel import ring
from cuking_tpu_torch.parallel.submatrix import Submatrix, num_shards
from cuking_tpu_torch.utils.status import InvalidArgumentError, ResourceExhaustedError
from cuking_tpu_torch.utils.synthetic import random_genotypes

SITES = 400


def jax_kernel(pi, pj, tri=None):
    return jax_matmul(pi, pj, tri, site_chunk_words=16)


def port_kernel(pi, pj, tri=None):
    return panel_counts_matmul(pi, pj, site_chunk_words=16)


def jax_out(g, n_dev, **kw):
    planes = jax_pack(g, JaxLayout.create(g.shape[1], words_multiple=16))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("samples",))
    return jring.all_pairs_sharded(planes, len(g), mesh, jax_kernel, **kw)


def port_out(g, n_dev, **kw):
    planes = pack_genotypes(g, PlaneLayout.create(g.shape[1]))
    kw.setdefault("kernel", port_kernel)
    return ring.all_pairs_sharded(planes, len(g), ring.RingMesh(["cpu"] * n_dev), **kw)


def assert_same(got, ref):
    assert len(got) == len(ref)
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(np.asarray(got.kin).view(np.uint32),
                          np.asarray(ref.kin).view(np.uint32))


def oracle(g, threshold):
    """The JAX package's numpy oracle: every pair i < j with kin > threshold."""
    kin, ibs0, ibs1, ibs2 = oracle_king(g, g)
    iu, ju = np.triu_indices(len(g), k=1)
    with np.errstate(invalid="ignore"):
        keep = kin[iu, ju] > np.float32(threshold)
    i, j = iu[keep].astype(np.int32), ju[keep].astype(np.int32)
    return ResultSet.concat_and_sort([ResultSet(
        i, j, kin[i, j], *(x[i, j].astype(np.int32) for x in (ibs0, ibs1, ibs2)))])


def both(g, n_dev, max_results=None, **kw):
    """(port, JAX) ResultSets of the same ring sweep."""
    got = ring.ring_output_to_resultset(
        port_out(g, n_dev, max_results=max_results, **kw), max_results)
    ref = jring.ring_output_to_resultset(
        jax_out(g, n_dev, max_results=max_results, **kw), max_results)
    return got, ref


# -- schedule algebra ---------------------------------------------------------


@pytest.mark.parametrize("num_devices", list(range(1, 17)))
def test_schedule_matches_jax(num_devices):
    assert ring.ring_schedule(num_devices) == jring.ring_schedule(num_devices)
    assert ring.ring_num_steps(num_devices) == jring.ring_num_steps(num_devices)


@pytest.mark.parametrize("row_multiple", [1, 8, 128, 256])
def test_sub_panel_and_wrap_split_match_jax(row_multiple):
    for nd in range(1, 600, 7):
        for requested in (1, 4, 16, 64, 1024):
            assert ring._choose_sub_panel(nd, requested, row_multiple) == \
                jring._choose_sub_panel(nd, requested, row_multiple)
        assert ring._wrap_split(nd, row_multiple) == jring._wrap_split(nd, row_multiple)


def test_default_capacity_matches_jax():
    for max_results in (1, 100, 1 << 14, 10 << 20, 123_457):
        for d in (1, 2, 3, 4, 8, 64):
            assert ring.default_capacity_per_device(max_results, d) == \
                jring.default_capacity_per_device(max_results, d)


# -- end-to-end parity --------------------------------------------------------


@pytest.mark.parametrize("num_devices", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("num_samples", [64, 70])  # divisible and ragged
def test_ring_matches_jax(num_devices, num_samples):
    g = random_genotypes(num_samples, SITES, missing_rate=0.1, seed=31,
                         num_related_pairs=4)
    got, ref = both(g, num_devices, kin_threshold=0.05, capacity_per_device=4096)
    assert len(ref) > 0
    assert_same(got, ref)


def test_keep_all_pairs_exactly_once():
    """Every finite-kin pair exactly once: a wrap block computed by both
    positions of a pair would emit duplicates."""
    g = random_genotypes(40, 300, missing_rate=0.05, seed=33)
    got, ref = both(g, 4, kin_threshold=-2.0, capacity_per_device=4096)
    assert_same(got, ref)
    assert len(set(zip(got.i_idx.tolist(), got.j_idx.tolist()))) == len(got)


@pytest.mark.parametrize("sub_panel", [4, 8, 16, 64])
def test_sub_panels_match_jax_oracle(sub_panel):
    """Sub-tiled steps equal whole-block ones, and cover each pair once."""
    g = random_genotypes(64, SITES, missing_rate=0.1, seed=38, num_related_pairs=4)
    for threshold in (0.05, -2.0):
        got = ring.ring_output_to_resultset(port_out(
            g, 4, kin_threshold=threshold, capacity_per_device=4096,
            sub_panel=sub_panel))
        assert len(got) > 0
        assert_same(got, oracle(g, threshold))


@pytest.mark.parametrize("num_samples,row_multiple,indexed", [
    (32, 1, False), (32, 1, True),
    (48, 8, False), (48, 8, True),  # p = 24, p1 = 8: misaligned to any 16-row tile
    (48, 1, True),                  # p1 = 12
])
def test_wrap_split_inside_one_sub_tile(num_samples, row_multiple, indexed):
    """D = 2 with the whole block as one sub-tile: the wrap block splits by
    rows inside it (p1 rows to the lower position); the higher half reads
    the visitor at row offset p1 through the indexed entry, and must equal
    the sliced run and the JAX ring."""
    g = wrap_genotypes(num_samples)
    kw = dict(kin_threshold=-2.0, capacity_per_device=4096, sub_panel=None,
              row_multiple=row_multiple)
    out = port_out(g, 2, indexed_kernel=panel_counts_cuda_indexed if indexed else None,
                   **kw)
    p = num_samples // 2
    p1 = ring._wrap_split(p, row_multiple)
    tri = p * (p - 1) // 2
    assert ring.ring_global_counts(out).tolist() == [tri + p1 * p, tri + p * (p - p1)]
    ref_counts, ref = jax_wrap_run(num_samples, row_multiple)
    assert out.counts.tolist() == ref_counts
    assert_same(ring.ring_output_to_resultset(out), ref)


def wrap_genotypes(num_samples):
    return random_genotypes(num_samples, 200, missing_rate=0.0, seed=51,
                            num_related_pairs=3)


@lru_cache(maxsize=None)
def jax_wrap_run(num_samples, row_multiple):
    out = jax_out(wrap_genotypes(num_samples), 2, kin_threshold=-2.0,
                  capacity_per_device=4096, sub_panel=None, row_multiple=row_multiple)
    return np.asarray(out.counts).tolist(), jring.ring_output_to_resultset(out)


@pytest.mark.parametrize("split_factor", [2, 3])
def test_merged_submatrix_rings_equal_jax_unsharded(split_factor):
    """Every Submatrix shard of a split-k cohort through the 8-position ring
    (diagonal shards: offset triangular ring; off-diagonal: rectangular
    ring), merged, equals the JAX ring over the whole cohort."""
    g = random_genotypes(90, SITES, missing_rate=0.1, seed=13, num_related_pairs=6)
    layout = PlaneLayout.create(SITES)
    mesh = ring.RingMesh(["cpu"] * 8)
    parts = []
    for shard in range(num_shards(split_factor)):
        sm = Submatrix.create(90, split_factor, shard)
        storage = PanelStorage(layout, sm, 16)
        stored = sm.stored_sample_indices()
        storage.planes[:, storage.storage_offsets(stored)] = pack_genotypes(g[stored], layout)
        out = ring.submatrix_pairs_sharded(
            storage, mesh, port_kernel, kin_threshold=0.05,
            capacity_per_device=4096, sub_panel=16)
        parts.append(ring.ring_output_to_resultset(out))
    ref = jring.ring_output_to_resultset(
        jax_out(g, 8, kin_threshold=0.05, capacity_per_device=4096))
    assert len(ref) > 0
    assert_same(ResultSet.concat_and_sort(parts), ref)


# -- overflow semantics -------------------------------------------------------


def test_overflow_auto_retry():
    """Buffers of 8 overflow; the global total is within max_results, so
    the sweep re-runs once at the pow2 bucket of the largest count."""
    g = random_genotypes(32, 200, missing_rate=0.0, seed=34)
    out = port_out(g, 4, kin_threshold=-2.0, capacity_per_device=8,
                   max_results=1 << 20)
    assert out.capacity_per_device == 1 << (int(out.counts.max()) - 1).bit_length()
    assert_same(ring.ring_output_to_resultset(out, 1 << 20), oracle(g, -2.0))


def test_retry_frees_the_first_hit_buffers():
    """When the retry's run starts, nothing holds the first run's hit
    buffers any more (weak references to them are dead), so a position
    never holds two sets; the rows equal the JAX ring's on the same forced
    overflow."""
    g = random_genotypes(32, 200, missing_rate=0.0, seed=34)
    mesh = ring.RingMesh(["cpu"] * 4)
    blocks, _ = ring._pad_and_shard(pack_genotypes(g, PlaneLayout.create(200)), 32, mesh, 1)
    first, alive = [], []

    def run(capacity):
        if first:
            alive.extend(ref() is not None for ref in first)
        out = ring._ring_fn(blocks, -2.0, mesh, kernel=port_kernel, num_samples=32,
                            capacity=capacity)
        if not first:
            first.extend(weakref.ref(h) for h in out.hits)
        return out

    out = ring._run_with_retry(run, 8, 1 << 20, True)
    assert alive == [False] * 4 and out.capacity_per_device > 8
    ref = jring.ring_output_to_resultset(
        jax_out(g, 4, kin_threshold=-2.0, capacity_per_device=8, max_results=1 << 20),
        1 << 20)
    assert_same(ring.ring_output_to_resultset(out, 1 << 20), ref)


def test_skewed_hits_auto_retry():
    """One dense family in the first position's row block overflows only
    that buffer; without max_results the reference's default bounds it."""
    rng = np.random.default_rng(41)
    g = rng.integers(0, 3, (64, SITES), dtype=np.int8)
    g[:16] = g[0]
    out = port_out(g, 4, kin_threshold=0.2, capacity_per_device=16)
    assert out.capacity_per_device > 16
    exp = oracle(g, 0.2)
    assert len(exp) >= 16 * 15 // 2
    assert_same(ring.ring_output_to_resultset(out), exp)


def test_rect_ring_skewed_retry():
    """An off-diagonal shard whose hits cluster in one position's block
    overflows and auto-retries through the rectangular ring."""
    rng = np.random.default_rng(47)
    g = rng.integers(0, 3, (64, SITES), dtype=np.int8)
    g[40:64] = g[8]
    sm = Submatrix.create(64, 2, 1)
    layout = PlaneLayout.create(SITES)
    storage = PanelStorage(layout, sm, 8)
    stored = sm.stored_sample_indices()
    storage.planes[:, storage.storage_offsets(stored)] = pack_genotypes(g[stored], layout)
    out = ring.submatrix_pairs_sharded(
        storage, ring.RingMesh(["cpu"] * 4), port_kernel, kin_threshold=0.2,
        capacity_per_device=8, sub_panel=8, max_results=1 << 20)
    ref = oracle(g, 0.2)
    keep = (ref.i_idx < 32) & (ref.j_idx >= 32)
    assert keep.sum() > 8  # capacity 8 genuinely overflowed
    assert_same(ring.ring_output_to_resultset(out, 1 << 20),
                ResultSet(*(getattr(ref, f)[keep] for f in (
                    "i_idx", "j_idx", "kin", "ibs0", "ibs1", "ibs2"))))


def test_no_retry_raises_like_jax_with_exact_counts():
    """auto_retry=False fails fast with the JAX message, from totals that
    stayed exact past capacity."""
    g = random_genotypes(32, 200, missing_rate=0.0, seed=34)
    out = port_out(g, 4, kin_threshold=-2.0, capacity_per_device=8, auto_retry=False)
    roomy = port_out(g, 4, kin_threshold=-2.0, capacity_per_device=4096)
    assert out.counts.tolist() == roomy.counts.tolist()
    assert out.counts.sum() == 32 * 31 // 2
    with pytest.raises(JaxResourceExhausted) as ref:
        jring._check_overflow(out.counts, 8, None)
    for extract in (ring.ring_output_to_resultset, ring.ring_output_local_resultset):
        with pytest.raises(ResourceExhaustedError, match="capacity") as got:
            extract(out)
        assert str(got.value) == str(ref.value)


def test_global_max_results_raises_like_jax():
    """The global total past --max_results is an error even when every
    buffer fits (cuking.cu:747-751), and auto-retry does not mask it."""
    g = random_genotypes(32, 200, missing_rate=0.0, seed=36)
    out = port_out(g, 4, kin_threshold=-2.0, capacity_per_device=4096, max_results=10)
    with pytest.raises(JaxResourceExhausted) as ref:
        jring._check_overflow(out.counts, 4096, 10)
    for extract in (ring.ring_output_to_resultset, ring.ring_output_local_resultset):
        with pytest.raises(ResourceExhaustedError, match="max_results") as got:
            extract(out, 10)
        assert str(got.value) == str(ref.value)


def test_local_resultset_equals_global():
    g = random_genotypes(50, SITES, missing_rate=0.1, seed=35, num_related_pairs=3)
    out = port_out(g, 8, kin_threshold=0.05, capacity_per_device=4096)
    full = ring.ring_output_to_resultset(out)
    assert len(full) > 0
    assert_same(ring.ring_output_local_resultset(out), full)
    # A process that holds only some positions must take the local extract.
    part = ring.RingOutput(out.hits[:3], out.counts, out.positions[:3])
    with pytest.raises(InvalidArgumentError, match="ring_output_local_resultset"):
        ring.ring_output_to_resultset(part)


def test_rotation_hands_tensors_on():
    """Positions sharing a device pass the tensor itself backwards (no copy
    into place, so no buffer a queued kernel reads is overwritten)."""
    mesh = ring.RingMesh(["cpu"] * 3)
    bufs = {p: torch.full((2, 4, 4), p, dtype=torch.int32) for p in range(3)}
    out = ring._rotate(bufs, mesh)
    assert [out[d] is bufs[(d + 1) % 3] for d in range(3)] == [True] * 3
    assert ring.RingMesh(["cpu", "cpu"], ranks=[0, 1], rank=1).local_positions == (1,)


# -- the order of rotations and steps -----------------------------------------


def _which(t, blocks):
    """The index of the block whose content ``t`` holds."""
    return next(k for k, b in enumerate(blocks) if b.shape == t.shape and torch.equal(b, t))


def recording_kernel(log, blocks_i, blocks_j):
    """The indexed count entry, logging each sub-tile as ("tile", step,
    position): position me visits block (me + t) mod D at step t."""
    d = len(blocks_j)

    def kernel(planes_i, i_off, j_off, tri, panel, planes_j, panel_j):
        me, b = _which(planes_i, blocks_i), _which(planes_j, blocks_j)
        log.append(("tile", (b - me) % d, me))
        return panel_counts_cuda_indexed(planes_i, i_off, j_off, tri, panel,
                                         planes_j=planes_j, panel_j=panel_j)

    return kernel


def record_rotations(monkeypatch, log):
    start, finish = ring._start_rotation, ring._finish_rotation

    def start_(*args):
        log.append(("start",))
        return start(*args)

    def finish_(*args):
        log.append(("finish",))
        return finish(*args)

    monkeypatch.setattr(ring, "_start_rotation", start_)
    monkeypatch.setattr(ring, "_finish_rotation", finish_)


def check_order(log, num_steps):
    """Rotation k starts before step k-1's first sub-tile and finishes after
    its last and before step k's first; never two are in flight."""
    starts = [i for i, e in enumerate(log) if e[0] == "start"]
    finishes = [i for i, e in enumerate(log) if e[0] == "finish"]
    assert len(starts) == len(finishes) == num_steps - 1
    steps = [[i for i, e in enumerate(log) if e[:2] == ("tile", t)] for t in range(num_steps)]
    assert all(steps) and len(log) == sum(map(len, steps)) + 2 * (num_steps - 1)
    for t in range(num_steps - 1):
        assert steps[t][-1] < steps[t + 1][0]
        assert starts[t] < steps[t][0]
        assert steps[t][-1] < finishes[t] < steps[t + 1][0]
    in_flight = 0
    for entry in log:
        in_flight += {"start": 1, "finish": -1}.get(entry[0], 0)
        assert 0 <= in_flight <= 1


def order_genotypes():
    return random_genotypes(60, SITES, missing_rate=0.1, seed=71, num_related_pairs=4)


@pytest.mark.parametrize("num_devices", [2, 3, 4])
def test_rotation_starts_a_step_ahead(monkeypatch, num_devices):
    """D = 2 and 4 (with the wrap step) and 3 (without), 60 samples in
    sub-tiles: each rotation starts before the step whose compute it can
    hide under and finishes before the step that reads it, one at a time,
    and the rows equal the JAX ring's."""
    g = order_genotypes()
    planes = pack_genotypes(g, PlaneLayout.create(SITES))
    mesh = ring.RingMesh(["cpu"] * num_devices)
    blocks, _ = ring._pad_and_shard(planes, len(g), mesh, 1)
    log = []
    record_rotations(monkeypatch, log)
    out = ring.all_pairs_presharded(
        blocks, len(g), mesh, port_kernel, kin_threshold=0.05, capacity_per_device=4096,
        sub_panel=8, indexed_kernel=recording_kernel(log, blocks, blocks))
    check_order(log, ring.ring_num_steps(num_devices))
    ref = jring.ring_output_to_resultset(
        jax_out(g, num_devices, kin_threshold=0.05, capacity_per_device=4096))
    assert len(ref) > 0
    assert_same(ring.ring_output_to_resultset(out), ref)


def rect_planes(g, sm, layout, pack):
    return (pack(g[sm.i_begin:sm.i_begin + sm.num_rows], layout),
            pack(g[sm.j_begin:sm.j_begin + sm.num_cols], layout))


def test_rect_rotation_starts_a_step_ahead(monkeypatch):
    """The rectangular ring of a split-2 off-diagonal shard on 4 positions:
    D steps, D - 1 rotations, each started before the step it can overlap
    and finished before the step that reads it; keep-all rows equal the
    JAX ring's."""
    g = order_genotypes()
    sm = Submatrix.create(len(g), 2, 1)
    assert not sm.is_diagonal
    planes_i, planes_j = rect_planes(g, sm, PlaneLayout.create(SITES), pack_genotypes)
    mesh = ring.RingMesh(["cpu"] * 4)
    blocks_i, _ = ring._pad_and_shard(planes_i, sm.num_rows, mesh, 1)
    blocks_j, _ = ring._pad_and_shard(planes_j, sm.num_cols, mesh, 1)
    log = []
    record_rotations(monkeypatch, log)
    rect = dict(i_offset=sm.i_begin, j_offset=sm.j_begin, kin_threshold=-2.0,
                capacity_per_device=4096, sub_panel=4)
    out = ring.rect_pairs_presharded(
        blocks_i, blocks_j, sm.num_rows, sm.num_cols, mesh, port_kernel,
        indexed_kernel=recording_kernel(log, blocks_i, blocks_j), **rect)
    check_order(log, 4)
    jax_i, jax_j = rect_planes(g, sm, JaxLayout.create(SITES, words_multiple=16), jax_pack)
    ref = jring.ring_output_to_resultset(jring.rect_pairs_sharded(
        jax_i, jax_j, sm.num_rows, sm.num_cols,
        Mesh(np.array(jax.devices()[:4]), axis_names=("samples",)), jax_kernel, **rect))
    assert len(ref) == sm.num_rows * sm.num_cols
    assert_same(ring.ring_output_to_resultset(out), ref)


class FakeDist:
    """torch.distributed's point-to-point calls for one rank of a ring whose
    other ranks are simulated: posts and waits are logged as a rotation's
    start and finish, and a receive is filled, when waited on, with the
    block its sender holds at that rotation (position d receives block
    (d + k) mod D at rotation k)."""

    isend, irecv = "isend", "irecv"

    def __init__(self, log, blocks, rotations_per_run):
        self.log, self.blocks, self.per_run = log, blocks, rotations_per_run
        self.posted = self.waited = 0

    @staticmethod
    def P2POp(op, tensor, peer, tag=0):
        return op, tensor, peer, tag

    def batch_isend_irecv(self, ops):
        self.posted += 1
        self.log.append(("start",))
        return [FakeWork(self, ops, (self.posted - 1) % self.per_run + 1)]


class FakeWork:
    def __init__(self, fake, ops, rotation):
        self.fake, self.ops, self.rotation = fake, ops, rotation

    def wait(self):
        self.fake.waited += 1
        self.fake.log.append(("finish",))
        d = len(self.fake.blocks)
        for op, tensor, _, tag in self.ops:
            if op == "irecv":
                tensor.copy_(self.fake.blocks[(tag + self.rotation) % d])


@pytest.mark.parametrize("ranks", [[0, 1], [0, 1, 2], [0, 0, 1, 1], [0, 1, 0, 1]])
def test_rank_rotation_posts_a_step_ahead(monkeypatch, ranks):
    """Each rank of a ring across processes, against simulated peers: the
    transfers of rotation t+1 are posted before step t's first sub-tile and
    waited on after its last and before step t+1's; the ranks' rows merged
    equal the JAX ring's."""
    g = order_genotypes()
    d = len(ranks)
    planes = pack_genotypes(g, PlaneLayout.create(SITES))
    blocks, _ = ring._pad_and_shard(planes, len(g), ring.RingMesh(["cpu"] * d), 1)
    parts = []
    for rank in sorted(set(ranks)):
        mesh = ring.RingMesh(["cpu"] * d, ranks=ranks, rank=rank)
        log = []
        monkeypatch.setattr(ring, "dist", FakeDist(log, blocks, ring.ring_num_steps(d) - 1))
        out = ring.all_pairs_presharded(
            [blocks[p] for p in mesh.local_positions], len(g), mesh, port_kernel,
            kin_threshold=0.05, capacity_per_device=4096, sub_panel=8,
            indexed_kernel=recording_kernel(log, blocks, blocks))
        check_order(log, ring.ring_num_steps(d))
        parts.append(ring.ring_output_local_resultset(out))
    ref = jring.ring_output_to_resultset(
        jax_out(g, d, kin_threshold=0.05, capacity_per_device=4096))
    assert len(ref) > 0
    assert_same(ResultSet.concat_and_sort(parts), ref)


def test_overflow_retry_starts_with_no_rotation_in_flight(monkeypatch):
    """A rank whose first run overflows its hit buffers re-runs the ring;
    when the retry starts, every transfer the first run posted has been
    waited on, and the ranks' rows merged equal the JAX ring's keep-all."""
    g = random_genotypes(32, 200, missing_rate=0.0, seed=34)
    ranks = [0, 1, 0, 1]
    planes = pack_genotypes(g, PlaneLayout.create(200))
    blocks, _ = ring._pad_and_shard(planes, 32, ring.RingMesh(["cpu"] * 4), 1)
    ring_fn = ring._ring_fn
    parts = []
    for rank in (0, 1):
        fake = FakeDist([], blocks, ring.ring_num_steps(4) - 1)
        monkeypatch.setattr(ring, "dist", fake)
        in_flight = []

        def run(*args, **kwargs):
            in_flight.append(fake.posted - fake.waited)
            return ring_fn(*args, **kwargs)

        monkeypatch.setattr(ring, "_ring_fn", run)
        mesh = ring.RingMesh(["cpu"] * 4, ranks=ranks, rank=rank)
        out = ring.all_pairs_presharded(
            [blocks[p] for p in mesh.local_positions], 32, mesh, port_kernel,
            kin_threshold=-2.0, capacity_per_device=8, max_results=1 << 20)
        assert in_flight == [0, 0] and out.capacity_per_device > 8
        assert fake.posted == fake.waited == 2 * (ring.ring_num_steps(4) - 1)
        parts.append(ring.ring_output_local_resultset(out, 1 << 20))
    ref = jring.ring_output_to_resultset(
        jax_out(g, 4, kin_threshold=-2.0, capacity_per_device=8, max_results=1 << 20),
        1 << 20)
    assert_same(ResultSet.concat_and_sort(parts), ref)


def check_round_robin(log, num_positions):
    """Within each step the positions take turns: the k-th sub-tile of every
    position that has one comes before any position's (k+1)-th."""
    tiles = [entry[1:] for entry in log if entry[0] == "tile"]
    for t in sorted({t for t, _ in tiles}):
        order = [me for s, me in tiles if s == t]
        seen = {me: 0 for me in order}
        turns = []
        for me in order:
            turns.append(seen[me])
            seen[me] += 1
        assert turns == sorted(turns), (t, order[:3 * num_positions])
        assert len(seen) == num_positions


@pytest.mark.parametrize("num_devices", [2, 3, 4])
def test_step_tiles_take_turns_over_positions(num_devices):
    """Each step's sub-tiles are queued round robin over the positions, so
    a card of a later position gets work from the step's start; the rows
    equal the oracle's."""
    g = order_genotypes()
    planes = pack_genotypes(g, PlaneLayout.create(SITES))
    mesh = ring.RingMesh(["cpu"] * num_devices)
    blocks, _ = ring._pad_and_shard(planes, len(g), mesh, 1)
    log = []
    out = ring.all_pairs_presharded(
        blocks, len(g), mesh, port_kernel, kin_threshold=0.05, capacity_per_device=4096,
        sub_panel=8, indexed_kernel=recording_kernel(log, blocks, blocks))
    check_round_robin(log, num_devices)
    assert_same(ring.ring_output_to_resultset(out), oracle(g, 0.05))


def test_rect_step_tiles_take_turns_over_positions():
    g = order_genotypes()
    sm = Submatrix.create(len(g), 2, 1)
    planes_i, planes_j = rect_planes(g, sm, PlaneLayout.create(SITES), pack_genotypes)
    mesh = ring.RingMesh(["cpu"] * 3)
    blocks_i, _ = ring._pad_and_shard(planes_i, sm.num_rows, mesh, 1)
    blocks_j, _ = ring._pad_and_shard(planes_j, sm.num_cols, mesh, 1)
    log = []
    out = ring.rect_pairs_presharded(
        blocks_i, blocks_j, sm.num_rows, sm.num_cols, mesh, port_kernel,
        i_offset=sm.i_begin, j_offset=sm.j_begin, kin_threshold=-2.0,
        capacity_per_device=4096, sub_panel=4,
        indexed_kernel=recording_kernel(log, blocks_i, blocks_j))
    check_round_robin(log, 3)
    ref = oracle(g, -2.0)
    keep = (ref.i_idx < sm.num_rows) & (ref.j_idx >= sm.j_begin)
    assert_same(ring.ring_output_to_resultset(out), ResultSet(*(
        getattr(ref, f)[keep] for f in ("i_idx", "j_idx", "kin", "ibs0", "ibs1", "ibs2"))))
