"""The plain reference against the golden rows and the port's CPU engine,
and its control against itself."""

import json
import os

import numpy as np
import pytest
import torch

from kingbench import check
from kingbench.reference.king import shard_rows
from kingbench.tests.tiny import SEED, spec

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "golden")


def _rows(g: np.ndarray, i_ids, j_ids, threshold, dtype=torch.float32):
    t = torch.from_numpy(g)
    return shard_rows(lambda ids, lo, hi: t[torch.as_tensor(ids), lo:hi], i_ids, j_ids,
                      g.shape[1], threshold, dtype=dtype, site_chunk=64)


@pytest.mark.parametrize("key,threshold", [("rows_default_threshold", 0.0884),
                                           ("rows_keep_all", -2.0)])
def test_reference_matches_golden(key, threshold):
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        expected = json.load(f)
    g = np.load(os.path.join(GOLDEN, "genotypes.npy"))
    want = np.array(sorted((int(r["i"][1:]), int(r["j"][1:]), r["kin_bits"], r["ibs0"],
                            r["ibs1"], r["ibs2"]) for r in expected[key]), np.int64)
    got = _rows(g, np.arange(g.shape[0]), None, threshold)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("split,shard", [(1, 0), (3, 1), (3, 3), (5, 4)])
def test_reference_matches_port_matmul_engine(split, shard):
    from cuking_tpu_torch.models.king import KingConfig, KingEngine
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    from kingbench.layout import Shard
    from kingbench.modes import sweep

    name, (_, config, traffic) = spec("sweep", split, shard, samples=301, sites=700)
    config["kin_threshold"] = -0.2
    g = np.full((301, 700), -1, np.int8)
    lay = Shard(301, split, shard, config["panel"])
    g[lay.sample_ids()] = sweep.draw(config, traffic, SEED, "cpu").numpy()
    engine = KingEngine.from_genotypes(
        g, KingConfig(kin_threshold=-0.2, panel=64, kernel="matmul", device="cpu",
                      site_chunk_words=8),
        submatrix=Submatrix.create(301, split, shard))
    got = sweep.rows_of(engine.run())
    want = sweep.reference_rows(config, traffic, SEED, "cpu")
    assert len(want) > 100
    assert check.compare(got, want) == dict.fromkeys(check.NUMBERS, 0)


@pytest.mark.parametrize("mode", ["sweep", "task"])
def test_control_is_not_correct(mode):
    """kin in bfloat16, the control, fails the comparison on a tiny cell."""
    import importlib

    name, (_, config, traffic) = spec(mode)
    m = importlib.import_module(f"kingbench.modes.{mode}")
    want = m.reference_rows(config, traffic, SEED, "cpu")
    got = m.reference_rows(config, traffic, SEED, "cpu", dtype=torch.bfloat16)
    numbers = check.compare(got, want)
    assert not check.correct(numbers)
    assert numbers["differing_rows"] > len(want) // 2
