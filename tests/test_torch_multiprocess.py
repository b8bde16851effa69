"""The port's --distributed CLI across real processes: each rank is
``python -m cuking_tpu_torch.cli --distributed`` under the torchrun
environment variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
LOCAL_RANK), on gloo with CPU positions.  The ranks rotate blocks with
``batch_isend_irecv``, ingest only their own rows, take the overflow retry
from all-reduced counts and write one partition each; merged, the
partitions equal the JAX CLI's output bit for bit.

NCCL refuses two ranks on one GPU, so cross-process rotation on CUDA needs
a multi-GPU host; chip_smoke.py runs a world of one with NCCL."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cuking_tpu import cli as jax_cli
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.parallel.submatrix import num_shards
from cuking_tpu_torch.utils.synthetic import random_genotypes

from tests.test_torch_cli import read_output_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_SAMPLES, NUM_SITES = 54, 400
CASE_TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, argv: list[str]) -> None:
    """Runs ``world`` ranks of the CLI and waits for all of them."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cuking_tpu_torch.cli", "--distributed", *argv],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outputs = [p.communicate(timeout=CASE_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out}"


@pytest.mark.parametrize("world,devices,split_factor,skew", [
    (2, "cpu,cpu", 1, False),   # D = 4: even, with the wrap step
    (3, "cpu", 1, False),       # D = 3: odd, no wrap step
    (2, "cpu,cpu", 2, False),   # every shard of split 2, partition shard x 2 + rank
    (2, "cpu", 1, True),        # one family + capacity 8: the retry across ranks
])
def test_distributed_cli_across_processes_matches_jax(tmp_path, world, devices,
                                                      split_factor, skew):
    g = random_genotypes(NUM_SAMPLES, NUM_SITES, missing_rate=0.1, seed=61,
                         num_related_pairs=4)
    if skew:
        g[:8] = g[0]  # 28 kin = 0.5 pairs inside the first position's rows
    inp = str(tmp_path / "in.parquet")
    write_synthetic_input(Storage(), inp, g)
    common = ["--input_uri", inp, "--kin_threshold", "0.05", "--quiet",
              "--split_factor", str(split_factor)]
    extra = ["--capacity_per_device", "8"] if skew else []
    for shard in range(num_shards(split_factor)):
        launch(world, [*common, "--shard_index", str(shard), "--device", devices,
                       "--output_uri", str(tmp_path / "port"), *extra])
        assert jax_cli.main([*common, "--shard_index", str(shard), "--kernel", "matmul",
                             "--output_uri", str(tmp_path / "jax")]) == 0
    parts = sorted(os.listdir(tmp_path / "port"))
    assert parts == [f"part-{k:05d}.snappy.parquet"
                     for k in range(world * num_shards(split_factor))]
    port, ref = read_output_rows(str(tmp_path / "port")), read_output_rows(str(tmp_path / "jax"))
    assert len(ref) >= (28 + 8 if skew else 4)
    assert port == ref
