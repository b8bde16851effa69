"""The port stands alone: importing any cuking_tpu_torch module loads neither
jax, cuking_tpu, triton, pyarrow nor hail, its tools load neither jax nor
cuking_tpu, and chip_smoke.py refuses to run without a CUDA device."""

import os
import subprocess
import sys

import pytest
import torch

from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed
from cuking_tpu_torch.utils.status import InvalidArgumentError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import cuking_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cuking_tpu_torch.__path__,
                                               "cuking_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "cuking_tpu", "triton",
                                    "pyarrow", "hail"))
print(len(names), bad)
"""


def test_port_imports_no_jax_triton_or_pyarrow():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20  # every module of the package was imported
    assert out[1].strip() == "[]"


_IMPORT_TOOLS = """
import sys
sys.path.insert(0, ".")
from tools import torch_baseline_parity, torch_capacity_plan, torch_shard_at_scale, torch_sweep_ab
plan = torch_capacity_plan.build_plan(150_000, 1_000_000)
torch_shard_at_scale.deployment_storage(1024, 300, 1, "cpu")
g = torch_baseline_parity.edge_case_genotypes(24, 300, 1)
torch_baseline_parity.expected_table(g, torch_baseline_parity.CATCH_ALL)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "cuking_tpu"))
print(plan["split_factor"], bad)
"""


def test_port_tools_import_no_jax():
    """The parity, capacity-plan, shard-at-scale and sweep A/B tools load
    neither jax nor cuking_tpu, not even through a numpy-only module of
    it."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_TOOLS], cwd=REPO, capture_output=True,
        text=True, check=True,
    ).stdout.split(maxsplit=1)
    assert out[0] == "1"
    assert out[1].strip() == "[]"


_RUN_SCALING = """
import contextlib, io, sys
sys.path.insert(0, ".")
from tools import torch_scaling_bench
with contextlib.redirect_stdout(io.StringIO()):
    rc = torch_scaling_bench.main(["--device", "cpu", "--devices", "1", "2"])
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "cuking_tpu"))
print(rc, bad)
"""


def test_scaling_tool_runs_without_jax():
    """The scaling tool, run through its CPU schedule check, loads neither
    jax nor cuking_tpu."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN_SCALING], cwd=REPO, capture_output=True,
        text=True, check=True,
    ).stdout.split(maxsplit=1)
    assert out[0] == "0"
    assert out[1].strip() == "[]"


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_entry_does_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: the meta device)."""
    planes = torch.empty((2, 16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(InvalidArgumentError, match="runs on CUDA"):
        panel_counts_cuda_indexed(planes, 0, 8, 0, 8)
