"""Shards of a split-5 cohort on the CPU, off the diagonal above all: 301
samples x 2,000 sites (blocks of 61 samples and a last one of 57) from a
seed, keep-all.  The port's CLI (``--device cpu``) writes the JAX CLI's
rows for the diagonal shards 0 and 14 and the off-diagonal shards 4 and 13,
kin as uint32 bits and the IBS counts exact; the port's 15 shards merge to
its split-1 rows; ``PanelStorage``'s offsets, membership and panels agree
with the JAX package's for every shard, also at 730,947 samples; and
``tools/torch_cli_at_scale.py`` runs shard 4 of a small split cohort as a
script, where a planted pair inside each block and between each block and
the others must not appear."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cuking_tpu import cli as jax_cli
from cuking_tpu.models.king import PanelStorage as JaxPanelStorage
from cuking_tpu.ops.bitset import PlaneLayout as JaxPlaneLayout
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix
from cuking_tpu_torch import cli
from cuking_tpu_torch.models.king import PanelStorage
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.parallel.submatrix import Submatrix, num_shards

tool = importlib.import_module("tools.torch_cli_at_scale")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COHORT = tool.Cohort(samples=301, sites=2000, files=4, sites_per_file=500, seed=23)
SPLIT = 5


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    inp = str(tmp_path_factory.mktemp("off_diagonal") / "in.parquet")
    tool.write_input(COHORT, inp, threads=2)
    return inp


def rows_of(output_uri: str) -> list:
    """(i, j, kin bits, ibs0, ibs1, ibs2) of every row, sorted."""
    return sorted((i, j, *v) for (i, j), v in tool.read_output(output_uri).items())


def run_port(inp: str, out: str, *extra) -> list:
    assert cli.main(["--input_uri", inp, "--output_uri", out, "--kin_threshold", "-2.0",
                     "--device", "cpu", "--quiet", *extra]) == 0
    return rows_of(out)


@pytest.mark.parametrize("shard", [0, 4, 13, 14])
def test_shard_equals_the_jax_cli(written, tmp_path, shard):
    shard_args = ["--split_factor", str(SPLIT), "--shard_index", str(shard)]
    port = run_port(written, str(tmp_path / "port"), *shard_args)
    assert jax_cli.main(["--input_uri", written, "--output_uri", str(tmp_path / "jax"),
                         "--kin_threshold", "-2.0", "--kernel", "matmul", "--quiet",
                         *shard_args]) == 0
    sm = Submatrix.create(COHORT.samples, SPLIT, shard)
    pairs = (sm.num_rows * (sm.num_rows - 1) // 2 if sm.is_diagonal
             else sm.num_rows * sm.num_cols)
    assert len(port) == pairs  # keep-all: every pair of the shard, once
    assert all(sm.i_begin <= i < sm.i_end and sm.j_begin <= j < sm.j_end and i < j
               for i, j, *_ in port)
    assert port == rows_of(str(tmp_path / "jax"))


def test_shards_merge_to_split_1(written, tmp_path):
    for shard in range(num_shards(SPLIT)):
        run_port(written, str(tmp_path / "split5"), "--split_factor", str(SPLIT),
                 "--shard_index", str(shard))
    split1 = run_port(written, str(tmp_path / "split1"))
    assert len(split1) == COHORT.samples * (COHORT.samples - 1) // 2
    assert rows_of(str(tmp_path / "split5")) == split1


@pytest.mark.parametrize("samples,panel", [(301, 128), (730_947, 1024)])
def test_storage_layout_equals_the_jax_package(samples, panel):
    """Offsets and membership over every sample index, and every panel's
    (offset, base, valid rows), of every shard; a 32-site layout keeps the
    planes of 730,947 samples small."""
    idx = np.arange(samples, dtype=np.int64)
    for shard in range(num_shards(SPLIT)):
        port = PanelStorage(PlaneLayout.create(32), Submatrix.create(samples, SPLIT, shard),
                            panel)
        ref = JaxPanelStorage(JaxPlaneLayout.create(32),
                              JaxSubmatrix.create(samples, SPLIT, shard), panel)
        assert port.planes.shape[:2] == ref.planes.shape[:2]  # stored rows
        inside = port.contains(idx)
        assert np.array_equal(inside, ref.contains(idx))
        assert np.array_equal(port.storage_offsets(idx[inside]),
                              ref.storage_offsets(idx[inside]))
        assert (port.num_i_panels, port.num_j_panels) == (ref.num_i_panels, ref.num_j_panels)
        assert [port.i_panel(k) for k in range(port.num_i_panels)] == [
            ref.i_panel(k) for k in range(ref.num_i_panels)]
        assert [port.j_panel(k) for k in range(port.num_j_panels)] == [
            ref.j_panel(k) for k in range(ref.num_j_panels)]
        # Each stored sample has a row of its own.
        offsets = port.storage_offsets(idx[inside])
        assert len(np.unique(offsets)) == inside.sum() and offsets.max() < port.planes.shape[1]


def test_shard_families_plant_the_edges_and_every_kind_outside():
    """Shard 4 of a split-5 cohort: the clone pair is its corners, the
    block and panel edges of both sections share a family, and planted
    pairs lie inside each block and between each block and the others."""
    c = tool.Cohort(samples=7_301, sites=500, files=1, sites_per_file=500, seed=5,
                    split_factor=SPLIT, shard_index=4)
    sm = c.submatrix
    assert (sm.i_begin, sm.i_end, sm.j_begin, sm.j_end) == (0, 1461, 5844, 7301)
    assert list(c.families[0][0]) == [0, 7300] and not c.families[0][1]
    rows, is_half = c.families[1]
    assert is_half and {1, 1023, 1024, 1460, 1461, 5844, 5845, 6867, 6868} <= set(rows.tolist())
    planted = {tuple(sorted((int(a), int(b)))): None for rows, _ in c.families
               for k, a in enumerate(rows) for b in rows[k + 1:]}
    inside, outside = tool.shard_pairs(c, planted)
    assert (0, 7300) in inside and (1460, 5844) in inside and (1023, 6868) in inside
    assert outside["blocks 0-0"] and outside["blocks 4-4"]
    assert tool.missing_kinds(c, outside) == []
    assert tool.missing_kinds(c, {"blocks 0-0": 1, "blocks 0-1": 1}) == [
        "inside block 4", "block 4 with a block outside the shard"]


def test_tool_runs_an_off_diagonal_shard_as_a_script(tmp_path):
    """The tool as a script (its own process, as on the card) on shard 4
    of 1,000 x 6,000 at split 5: exit 0, every check passed, the rows
    exactly the planted pairs of the shard, none of the planted pairs
    inside block 0 or 4 or between either and blocks 1-3."""
    proc = subprocess.run(
        [sys.executable, "tools/torch_cli_at_scale.py", "--device", "cpu", "--samples", "1000",
         "--sites", "6000", "--files", "3", "--sites-per-file", "2000", "--split-factor", "5",
         "--shard-index", "4", "--ingest-runs", "0", "--ab-runs", "0",
         "--workdir", str(tmp_path)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["failures"] == []
    assert result["submatrix"] == [0, 200, 800, 1000]
    outside = result["planted"]["outside_by_blocks"]
    assert outside["blocks 0-0"] > 0 and outside["blocks 4-4"] > 0
    assert sum(n for k, n in outside.items() if k.startswith("blocks 0-") and k != "blocks 0-0")
    assert result["output"]["rows"] == result["output"]["planted_pairs"] > 0
    t = result["task"]
    assert t["rows_differing"] == [] and t["offsets_differing"] == []
    assert min(t["sections_checked"]) > 0 and t["padding_rows"] == 2 * 256 - 400
    assert t["padding_not_missing"] == []
    assert t["plane_tallies"] == result["input"]["shard_tallies"]
    assert t["ingest_entries"] == result["input"]["entries"]
    assert 0 < t["ingest_kept"] == result["input"]["shard_entries"] < t["ingest_entries"]
    assert os.listdir(tmp_path) == []  # the input is deleted
