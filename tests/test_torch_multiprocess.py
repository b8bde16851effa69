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
LAUNCH_ATTEMPTS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, argv: list[str], port: int) -> list[tuple[int, str]] | None:
    """Each rank's exit code and output, or None when rank 0 could not
    listen on ``port`` (the others are then stopped, not waited for)."""
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
        outputs = [procs[0].communicate(timeout=CASE_TIMEOUT_S)[0]]
        if procs[0].returncode != 0 and "EADDRINUSE" in outputs[0]:
            return None
        outputs += [p.communicate(timeout=CASE_TIMEOUT_S)[0] for p in procs[1:]]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outputs)]


def launch(world: int, argv: list[str], draw_port=_free_port) -> None:
    """Runs ``world`` ranks of the CLI and waits for all of them.

    ``_free_port`` closes its socket before rank 0 binds the port, so a test
    on another xdist worker can draw the same one meanwhile; rank 0 then
    fails with EADDRINUSE, and the launch runs again on a new port, at most
    LAUNCH_ATTEMPTS times in all."""
    for _ in range(LAUNCH_ATTEMPTS):
        results = _run_ranks(world, argv, draw_port())
        if results is not None:
            break
    else:
        pytest.fail(f"rank 0 found its port in use {LAUNCH_ATTEMPTS} times")
    for rank, (code, out) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{out}"


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


def test_launch_retries_when_rank_0_finds_its_port_taken(tmp_path):
    """The port drawn first already has a listener, as another worker's
    store would: rank 0 fails with EADDRINUSE, which the CLI's error names,
    and the launch goes on to a second port and a full run."""
    g = random_genotypes(NUM_SAMPLES, NUM_SITES, missing_rate=0.1, seed=62,
                         num_related_pairs=2)
    inp = str(tmp_path / "in.parquet")
    write_synthetic_input(Storage(), inp, g)
    drawn = []
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()

        def draw_port() -> int:
            drawn.append(taken.getsockname()[1] if not drawn else _free_port())
            return drawn[-1]

        launch(2, ["--input_uri", inp, "--kin_threshold", "0.05", "--quiet",
                   "--device", "cpu", "--output_uri", str(tmp_path / "port")],
               draw_port)
    assert len(drawn) == 2 and drawn[0] != drawn[1]
    assert sorted(os.listdir(tmp_path / "port")) == [
        f"part-{k:05d}.snappy.parquet" for k in range(2)]
    assert len(read_output_rows(str(tmp_path / "port"))) >= 2
