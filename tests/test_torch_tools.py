"""The port's repo-level tools on the CPU: ``tools/torch_baseline_parity.py``
(the twin of ``tools/baseline_parity.py``) through the port's CLI with
``--device cpu``, its oracle against the JAX tool's, bit for bit,
``tools/torch_capacity_plan.py``'s split factor against the CLI's own
memory check, ``check_engine_fit``, and ``tools/torch_scaling_bench.py``'s
schedule check and planted hits against ``tools/scaling_bench.py``'s."""

import importlib
import json
import os
import re

import numpy as np
import pytest
import torch

from cuking_tpu_torch.models.king import KingConfig
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.parallel.submatrix import Submatrix, num_shards
from cuking_tpu_torch.utils.hbm import check_engine_fit
from cuking_tpu_torch.utils.status import InvalidArgumentError

parity = importlib.import_module("tools.torch_baseline_parity")
jax_parity = importlib.import_module("tools.baseline_parity")
plan_tool = importlib.import_module("tools.torch_capacity_plan")
scaling = importlib.import_module("tools.torch_scaling_bench")

SMALL = ["--samples", "96", "--sites", "2000"]


def test_baseline_parity_tool_small(tmp_path, capsys):
    """All three checks at 96 x 2,000 on the plain path: the catch-all run
    against the oracle, the thresholded run, and the split-4 merge."""
    rc = parity.main(["--device", "cpu", *SMALL, "--workdir", str(tmp_path / "bp")])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"differences": {"full": 0, "thresholded": 0, "split_merge": 0}' in out
    assert '"shards": 10' in out


def test_baseline_parity_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert parity.main(SMALL) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("threshold", ["catch-all", 0.0884])
def test_oracle_table_matches_the_jax_tool(threshold):
    """The same cohort and the same oracle rows as tools/baseline_parity.py,
    kin as uint32 bits, at 96 x 2,000."""
    g = parity.edge_case_genotypes(96, 2000, 42)
    assert np.array_equal(g, jax_parity.edge_case_genotypes(96, 2000, 42))
    t = parity.CATCH_ALL if threshold == "catch-all" else threshold
    got, got_nonfinite, got_spot = parity.expected_table(g, t)
    ref, ref_nonfinite, ref_spot = jax_parity.expected_table(g, t)
    assert (got_nonfinite, got_spot) == (ref_nonfinite, ref_spot)
    assert got.dtype == ref.dtype and len(got) == len(ref) > 0
    for field in ref.dtype.names:
        assert np.array_equal(got[field], ref[field]), field


def test_parity_counts_differing_rows():
    g = parity.edge_case_genotypes(24, 300, 1)
    want, _, _ = parity.expected_table(g, parity.CATCH_ALL)
    got = want.copy()
    got.ibs1[3] += 1
    got.kin_bits[5] ^= 1
    lines = []
    assert parity.compare("t", got, want, lines.append) == 2
    assert parity.compare("t", got[:-1], want, lines.append) == len(want)
    assert parity.compare("t", want.copy(), want, lines.append) == 0


def _worst_fits(samples, words, k, limit) -> bool:
    """Every shard of split k passes check_engine_fit."""
    config = KingConfig()
    try:
        for idx in range(num_shards(k)):
            check_engine_fit(samples, words, Submatrix.create(samples, k, idx), config, k,
                             bytes_limit=limit)
    except InvalidArgumentError:
        return False
    return True


@pytest.mark.parametrize("samples,sites,split", [
    (400_000, 1_000_000, 3),
    (5_000_000, 100_000, 4),
])
def test_capacity_plan_picks_the_least_split_that_fits(samples, sites, split):
    plan = plan_tool.build_plan(samples, sites)
    words = PlaneLayout.create(sites).words
    assert plan["split_factor"] == split and plan["words"] == words
    assert _worst_fits(samples, words, split, plan["usable_bytes"])
    assert not _worst_fits(samples, words, split - 1, plan["usable_bytes"])
    assert plan["tasks"] == split * (split + 1) // 2
    hours = plan["gpu_hours"]
    assert hours["total"] == pytest.approx(hours["ingest"] + hours["sweep"] + hours["startup"])


def test_capacity_plan_cli(capsys):
    """The JAX tool's own example: 150,000 x 1,000,000 fits one card, one task;
    with 1 GiB no split factor fits."""
    assert plan_tool.main(["--samples", "150000", "--sites", "1000000"]) == 0
    out = capsys.readouterr()
    assert '"split_factor": 1' in out.out and '"tasks": 1' in out.out
    assert "not a 26-vCPU task's" in out.err
    assert plan_tool.main(["--bytes", str(1 << 30)]) == 1
    assert '"split_factor": null' in capsys.readouterr().out


def test_step_time_is_linear_in_words():
    assert plan_tool.step_ms(3_128) == pytest.approx(1.11)
    assert plan_tool.step_ms(31_252) == pytest.approx(10.55)
    assert plan_tool.step_ms((3_128 + 31_252) // 2) == pytest.approx((1.11 + 10.55) / 2)


def test_scaling_bench_validates_the_schedule_on_the_cpu(capsys):
    """D = 1..4 on the plain path: the same 52 planted hits at every D, the
    ring's steps and sub-tiles as scheduled, and the JSON's keys; no rate or
    efficiency is reported for a CPU run."""
    from cuking_tpu_torch.parallel.ring import ring_num_steps

    assert scaling.main(["--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"weak_scaling", "overlap", "target_efficiency", "device"}
    rows = report["weak_scaling"]
    assert [r["devices"] for r in rows] == [1, 2, 3, 4]
    assert {r["hits"] for r in rows} == {scaling.expected_hits(scaling.CPU_FAMILIES)} == {52}
    for r in rows:
        assert r["ring_steps"] == ring_num_steps(r["devices"])
        assert r["sub_tiles"] == scaling.schedule_sub_tiles(r["devices"], 2)
        assert not any("per_sec" in k or "efficiency" in k for k in r)
    assert report["overlap"] is None and report["device"]["platform"] == "cpu"


def test_scaling_bench_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert scaling.main(["--devices", "1", "2"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_scaling_bench_plants_the_jax_tools_families():
    """The families, threshold, default sizes and expected hit counts read
    from tools/scaling_bench.py as text (importing it would load jax's
    platform override): 32 families of 4 on the accelerator and 8 on the
    CPU, each plus the 4 pairs of row 0's clone in the last row."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools", "scaling_bench.py")
    with open(path) as f:
        src = f.read()
    fams = [int(n) for n in re.findall(r"for fam in range\((\d+)\):", src)]
    assert fams == [scaling.GPU_FAMILIES, scaling.CPU_FAMILIES]
    assert re.findall(r"src = fam \* (\d+)", src) == [str(scaling.FAMILY_SIZE)] * 2
    assert re.findall(r"for m in range\(1, (\d+)\):", src) == [str(scaling.FAMILY_SIZE)] * 2
    for fam, n, per in re.findall(r"expected_hits = (\d+) \* (\d+) \* (\d+) // 2", src):
        assert int(fam) * int(n) * int(per) // 2 + 4 == scaling.expected_hits(int(fam))
    assert "expected_d = expected_hits + 4" in src
    assert f"threshold = {scaling.THRESHOLD}" in src
    assert "16384 if on_tpu else 64" in src and "100_000 if on_tpu else 2_000" in src
    assert "missing_rate=0.05, seed=1" in src
    assert scaling.expected_hits(scaling.GPU_FAMILIES) == 196


def test_scaling_bench_counts_transfers_under_their_own_cards_kernels():
    """A transfer is covered only by count kernels on its own card, and
    overlapping kernels count once."""
    intervals = [
        (0, "transfer", 0.0, 10.0), (0, "kernel", 2.0, 6.0), (0, "kernel", 4.0, 8.0),
        (1, "kernel", 0.0, 10.0), (1, "transfer", 20.0, 30.0),
    ]
    got = scaling.covered_share(intervals)
    assert got["num_transfers"] == 2
    assert got["transfer_ms"] == pytest.approx(0.020)
    assert got["covered_ms"] == pytest.approx(0.006)
    assert got["overlap_fraction"] == pytest.approx(0.3)
    assert scaling.covered_share([(0, "kernel", 0.0, 1.0)]) is None
    assert scaling.schedule_sub_tiles(4, 16) == 4 * (136 + 256) + 2 * 256
    assert scaling.schedule_sub_tiles(2, 1) == 2 * 1 + 2
