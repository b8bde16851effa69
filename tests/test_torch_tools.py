"""The port's repo-level tools on the CPU: ``tools/torch_baseline_parity.py``
(the twin of ``tools/baseline_parity.py``) through the port's CLI with
``--device cpu``, its oracle against the JAX tool's, bit for bit, and
``tools/torch_capacity_plan.py``'s split factor against the CLI's own
memory check, ``check_engine_fit``."""

import importlib

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
    assert "not measurements at scale" in out.err
    assert plan_tool.main(["--bytes", str(1 << 30)]) == 1
    assert '"split_factor": null' in capsys.readouterr().out


def test_step_time_is_linear_in_words():
    assert plan_tool.step_ms(3_128) == pytest.approx(1.11)
    assert plan_tool.step_ms(31_252) == pytest.approx(10.6)
    assert plan_tool.step_ms((3_128 + 31_252) // 2) == pytest.approx((1.11 + 10.6) / 2)
