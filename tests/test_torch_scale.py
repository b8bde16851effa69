"""The port at a deployment's shard size, as far as the CPU can show it:
the clone-family helper through the port's engine (plain path) against the
JAX KingEngine on the same planes, the rows whose words lie past 2^31 and
2^32 at 1,000,000 sites, and the fit check and the cohort plan at the
card's limit.  ``chip_smoke.py`` phase 13 runs these shards on the card."""

import numpy as np
import pytest

from cuking_tpu.models.king import KingConfig as JaxConfig
from cuking_tpu.models.king import KingEngine as JaxEngine
from cuking_tpu.models.king import PanelStorage as JaxStorage
from cuking_tpu.ops.bitset import PlaneLayout as JaxLayout
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix

from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils.hbm import (
    check_engine_fit,
    engine_plane_bytes,
    sweep_buffer_bytes,
)
from cuking_tpu_torch.utils.status import InvalidArgumentError
from cuking_tpu_torch.utils.synthetic import (
    plant_clone_families,
    random_planes,
    rows_past_word_limits,
)
from tools import torch_capacity_plan as plan_tool
from tools import torch_shard_at_scale as shard_tool

ROWS, SITES, PANEL = 2_304, 3_000, 256
WORDS_1M = PlaneLayout.create(1_000_000).words  # 31,252
# Read on an NVIDIA H100 80GB HBM3 (700.00 W): the usable bytes (92% of the
# free memory) that chip_smoke.py phase 13b's fit check was given.
PHASE_13B_LIMIT = 77_522_662_850


@pytest.fixture(scope="module")
def family_planes():
    """Random planes with families of 4 in the first, middle and last
    panels, and row 0 cloned into the last row."""
    planes = random_planes(ROWS, PlaneLayout.create(SITES), np.random.default_rng(23))
    middle = ROWS // 2
    planted = plant_clone_families(planes, [
        range(0, 4), range(middle - 2, middle + 2), range(ROWS - 5, ROWS - 1), (0, ROWS - 1)])
    return planes, planted


def test_family_helper_plants_the_pairs(family_planes):
    planes, planted = family_planes
    assert len(planted) == 10 + 6 + 6  # row 0's family has 5 rows
    assert (0, ROWS - 1) in planted and (ROWS - 5, ROWS - 2) in planted
    for i, j in planted:
        assert np.array_equal(planes[:, i], planes[:, j])
    assert not np.array_equal(planes[:, 4], planes[:, 0])


@pytest.mark.parametrize("threshold", [0.0884, -0.45])
def test_planted_shard_matches_the_jax_engine(family_planes, threshold):
    """At 0.0884 exactly the planted pairs come out, with kin == 0.5; at
    -0.45 about a twentieth of the random pairs pass too.  Either way the
    port's engine equals the JAX engine (matmul kernel) on the same planes:
    kin as uint32 bits, IBS counts exact."""
    planes, planted = family_planes
    storage = PanelStorage(PlaneLayout.create(SITES), Submatrix.create(ROWS, 1, 0), PANEL)
    storage.planes[:] = planes
    got = KingEngine(storage, KingConfig(panel=PANEL, device="cpu",
                                         kin_threshold=threshold)).run()
    jax_storage = JaxStorage(JaxLayout.create(SITES, words_multiple=4),
                             JaxSubmatrix.create(ROWS, 1, 0), PANEL)
    jax_storage.planes[:] = planes
    ref = JaxEngine(jax_storage, JaxConfig(panel=PANEL, kernel="matmul", site_chunk_words=32,
                                           kin_threshold=threshold)).run()
    assert len(got) == len(ref) > 0
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))
    if threshold > 0:
        assert list(zip(got.i_idx.tolist(), got.j_idx.tolist())) == planted
        assert np.all(got.kin.view(np.uint32) == np.float32(0.5).view(np.uint32))
        assert np.all(got.ibs0 == 0) and np.all(got.ibs1 == 0)


@pytest.mark.parametrize("rows,het,hom", [
    (69_632, 68_716, 67_799),   # chip_smoke.py phase 13a
    (36_864, 36_864, 36_864),   # the GPU tests' store: only hom rows from 31,854 pass 2^31
    (307_200, 68_716, 0),       # phase 13b's shard: the whole hom plane lies past 2^32
])
def test_rows_past_word_limits_at_1m_sites(rows, het, hom):
    assert rows_past_word_limits(rows, WORDS_1M) == (het, hom)
    w = WORDS_1M
    if het < rows:  # the het row before it straddles word 2^31
        assert (het - 1) * w < 2**31 <= het * w
    if 0 < hom < rows:
        assert rows * w + (hom - 1) * w < 2**32 <= rows * w + hom * w
    if hom == 0:
        assert rows * w >= 2**32


def test_phase_13a_families_cross_both_limits():
    """The families of chip_smoke.py phase 13a: rows 0-3 with row 0's clone
    in the last row, one across each limit, one in the last panel."""
    rows = 69_632
    groups = shard_tool.family_groups(rows, WORDS_1M)
    assert [tuple(g) for g in groups] == [
        (0, 1, 2, 3), (68_714, 68_715, 68_716, 68_717), (67_797, 67_798, 67_799, 67_800),
        (69_627, 69_628, 69_629, 69_630), (0, 69_631)]
    planes = np.arange(2 * rows, dtype=np.uint32).reshape(2, rows, 1)
    assert len(plant_clone_families(planes, groups)) == 10 + 3 * 6


def test_shard_tool_finds_the_planted_pairs_on_the_cpu():
    """The tool's storage (planes drawn by torch from a seed), families and
    check on a small shard through the plain path; a wrong kin fails the
    check."""
    storage, planted = shard_tool.deployment_storage(2_048, 3_000, 5, "cpu")
    rs = KingEngine(storage, KingConfig(panel=1024, device="cpu")).run()
    shard_tool.check_planted(rs, storage, planted)
    rs.kin[3] = np.nextafter(np.float32(0.5), np.float32(1))
    with pytest.raises(RuntimeError, match="float32"):
        shard_tool.check_planted(rs, storage, planted)


def test_fit_check_admits_r_rows_and_refuses_the_next_panel():
    """At 1,000,000 sites and phase 13b's limit, check_engine_fit admits
    the 307,200 rows the card admitted, and refuses 1,024 more, naming
    split 3 (an off-diagonal shard of split 2 stores two blocks of 154,624
    rows); R is the planes' share of the limit in whole panels."""
    config = KingConfig(device="cpu")
    rows = plan_tool.largest_diagonal_rows(WORDS_1M, PHASE_13B_LIMIT, config)
    panel_bytes = 2 * 1024 * WORDS_1M * 4
    assert rows == (PHASE_13B_LIMIT - sweep_buffer_bytes(config)) // panel_bytes * 1024
    assert rows == 307_200
    check_engine_fit(rows, WORDS_1M, Submatrix.create(rows, 1, 0), config, 1,
                     bytes_limit=PHASE_13B_LIMIT)
    with pytest.raises(InvalidArgumentError, match="--split_factor to at least 3"):
        check_engine_fit(rows + 1024, WORDS_1M, Submatrix.create(rows + 1024, 1, 0), config,
                         1, bytes_limit=PHASE_13B_LIMIT)


def test_batch_planes_term_follows_from_the_fit_check():
    """cloud/batch_submit.py's planes term, 74,096 MiB: 92% of the card's
    total memory less the default sweep buffers, the most that
    check_engine_fit can admit on an H100 80GB HBM3 (free memory never
    exceeds the total); at 1,000,000 sites whole panels leave less."""
    config = KingConfig(device="cpu")
    usable = int(plan_tool.H100_TOTAL_MEMORY * 0.92)
    term = (usable - sweep_buffer_bytes(config)) >> 20
    assert term == 74_096
    rows = plan_tool.largest_diagonal_rows(WORDS_1M, usable, config)
    planes = engine_plane_bytes(Submatrix.create(rows, 1, 0), WORDS_1M, 1024)
    assert term - 245 < planes >> 20 <= term


def test_plan_admits_no_shard_the_card_refuses():
    """The plan's limit is 92% of the free memory a task's process sees, not
    of the card's total: the CUDA context holds the difference, so at the
    total the plan admitted two panels that the CLI's own check refuses."""
    config = KingConfig(device="cpu")
    task_limit = int(plan_tool.H100_FREE_MEMORY * 0.92)
    rows = plan_tool.largest_diagonal_rows(WORDS_1M, task_limit, config)
    assert rows == 308_224
    assert plan_tool.build_plan(rows, 1_000_000)["split_factor"] == 1
    assert plan_tool.build_plan(rows + 1024, 1_000_000)["split_factor"] == 3
    with pytest.raises(InvalidArgumentError, match="--split_factor"):
        check_engine_fit(rows + 1024, WORDS_1M, Submatrix.create(rows + 1024, 1, 0),
                         config, 1, bytes_limit=task_limit)


@pytest.mark.parametrize("spare, rows, set_by", [(0, 307_200, "card"),
                                                  (-1, 306_176, "host")])
def test_fit_limit_shard_is_sized_by_the_host_below_its_planes(spare, rows, set_by):
    """Phase 13b's shard is the card's fit limit only while the host's
    available memory holds its 300 panels of planes and the tool's 8 GiB
    reserve, 85,394,849,792 B; one byte less and the host sets the size, a
    panel fewer, and says so."""
    config = KingConfig(device="cpu")
    need = 300 * 8 * 1024 * WORDS_1M + shard_tool.HOST_RESERVE_BYTES
    assert need == 85_394_849_792
    assert shard_tool.shard_rows(WORDS_1M, config, PHASE_13B_LIMIT, need + spare) == (
        rows, set_by, rows)


def test_cli_limit_probe_stops_at_the_fit_check(tmp_path):
    """chip_smoke.py phase 0b's probe runs the CLI up to its check_engine_fit
    call, prints the free memory and the limit read there, and exits before
    ingest writes anything (here on the CPU, with a stand-in free reading)."""
    import json
    import os
    import subprocess
    import sys

    import chip_smoke

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    stand_in = "import torch\ntorch.cuda.mem_get_info = lambda device: (123, 456)\n"
    proc = subprocess.run(
        [sys.executable, "-c", stand_in + chip_smoke._CLI_LIMIT_PROBE,
         "--input_uri", os.path.join(repo, "tests/golden/input.parquet"),
         "--output_uri", str(tmp_path / "out.parquet"), "--kin_threshold", "0.0884",
         "--device", "cpu"],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [123, None]
    assert not os.path.exists(tmp_path / "out.parquet")
