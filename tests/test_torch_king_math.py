"""The port's fp32 KING epilogue is bit-exact with the JAX package's
(cuking_tpu/ops/king_math.py), including min_hets == 0 (NaN, +inf, -inf)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuking_tpu.ops import king_math as jax_math
from cuking_tpu_torch.ops import king_math as torch_math


def _counts(seed: int, n: int = 4096) -> dict:
    rng = np.random.default_rng(seed)
    c = {
        name: rng.integers(0, 60_000, n, dtype=np.int32)
        for name in ("both_het", "het_i", "het_j", "opposing_hom",
                     "concordant_hom", "shared_sites")
    }
    # min_hets == 0 rows: one-sided zeros (random sign of the numerator),
    # then 0/0 → NaN, positive/0 → +inf, negative/0 → -inf.
    c["het_i"][0::8] = 0
    c["het_j"][1::8] = 0
    c["het_i"][2::8] = 0
    c["het_j"][2::8] = 0
    c["both_het"][2::8] = 0
    c["opposing_hom"][2::8] = 0   # NaN
    c["het_i"][3::8] = 0
    c["het_j"][3::8] = 0
    c["both_het"][3::8] = 5
    c["opposing_hom"][3::8] = 0   # +inf
    c["het_i"][4::8] = 0
    c["het_j"][4::8] = 0
    c["both_het"][4::8] = 0
    c["opposing_hom"][4::8] = 7   # -inf
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epilogue_bit_exact_with_jax(seed):
    c = _counts(seed)
    ref = jax_math.king_from_counts(
        jax_math.KingCounts(**{k: jnp.asarray(v) for k, v in c.items()}))
    got = torch_math.king_from_counts(
        torch_math.KingCounts(**{k: torch.from_numpy(v) for k, v in c.items()}))
    ref_kin = np.asarray(ref.kin)
    got_kin = got.kin.numpy()
    assert got.kin.dtype == torch.float32
    assert np.isnan(ref_kin).any() and np.isposinf(ref_kin).any()
    assert np.isneginf(ref_kin).any()
    assert np.array_equal(got_kin.view(np.uint32), ref_kin.view(np.uint32))
    for f in ("ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
