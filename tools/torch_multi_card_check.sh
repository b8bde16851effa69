#!/bin/bash
# The PyTorch/CUDA port on every card of a multi-GPU machine, from the
# repository root:
#
#     bash tools/torch_multi_card_check.sh [PARENT_CHECKOUT]
#
# 1. With PARENT_CHECKOUT (an unpacked older commit), that commit's kernel
#    launched on cuda:0 and then on cuda:1 in one process; each launch
#    prints ok or the error it raised.
# 2. The GPU tests (the every-card test launches on each card in both
#    orders and runs a ring with one position per card).
# 3. The CLI at 1,000 x 10,000: --use_mesh with its default devices (one
#    position per card) and one CLI per card with --distributed (NCCL),
#    each against --device cuda on one card.
# 4. chip_smoke.py's cell A (32,768 x 100,000, threshold 0.0884, 64 planted
#    duplicates) through a ring of 4 positions, all on cuda:0 and one per
#    card, in turns (one card, all cards, all cards, one card): the host
#    clock of each sweep, ending when every card is done, and its rows
#    against the engine's on cuda:0.
set -u
cd "$(dirname "$0")/.."
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
LAUNCH='
import torch
from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed
p = torch.randint(-2**31, 2**31 - 1, (2, 256, 100), dtype=torch.int32)
for k in (0, 1):
    try:
        panel_counts_cuda_indexed(p.to(f"cuda:{k}"), 0, 128, 0, 128)
        torch.cuda.synchronize(k)
        print("parent: launch on cuda", k, "ok", flush=True)
    except Exception as e:
        print("parent: launch on cuda", k, "raised", type(e).__name__, e, flush=True)
'
if [ -n "${1:-}" ]; then (cd "$1" && timeout 120 python -c "$LAUNCH"); fi
timeout 300 python -m pytest tests/test_torch_gpu.py -m gpu -q -p no:cacheprovider 2>&1 | tail -2
timeout 400 python - <<'PY'
import os, subprocess, sys, tempfile

import torch

import chip_smoke as cs
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.utils.synthetic import random_genotypes

with tempfile.TemporaryDirectory() as tmp:
    g = random_genotypes(1000, 10_000, missing_rate=0.05, seed=cs.SEED, num_related_pairs=5)
    inp = f"{tmp}/in.parquet"
    write_synthetic_input(Storage(), inp, g)
    cs.run_cli(inp, f"{tmp}/one", "--device", "cuda")
    cs.run_cli(inp, f"{tmp}/mesh", "--use_mesh")
    one = cs._rows(f"{tmp}/one")
    print("--use_mesh (one position per card) == one card:",
          cs._rows(f"{tmp}/mesh") == one, flush=True)
    world, port = torch.cuda.device_count(), str(cs._free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", cs._CHILD, "--input_uri", inp, "--output_uri",
         f"{tmp}/dist", "--distributed"],
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(r),
                 WORLD_SIZE=str(world), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    rcs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        rcs.append(p.returncode)
        print(" | ".join(out.strip().splitlines()[-2:]))
    print(f"--distributed over {world} cards (NCCL): exit codes {rcs}, == one card:",
          all(rc == 0 for rc in rcs) and cs._rows(f"{tmp}/dist") == one)
PY
timeout 900 python - <<'PY'
import time

import torch

import chip_smoke as cs
from cuking_tpu_torch.parallel.ring import (
    RingMesh, _pad_and_shard, all_pairs_presharded, ring_output_to_resultset)

card = cs.phase_env()
_, storage, engine_rs = cs.phase_engine(card)
n = storage.submatrix.num_rows
cards = torch.cuda.device_count()
for devices in (["cuda:0"] * 4, [f"cuda:{k % cards}" for k in range(4)]) * 2:
    mesh = RingMesh(devices)
    blocks, _ = _pad_and_shard(storage.planes, n, mesh, 1)
    for k in range(cards):
        torch.cuda.synchronize(k)
    t = time.perf_counter()
    out = all_pairs_presharded(blocks, n, **cs.ring_kw(mesh=mesh, kin_threshold=0.0884))
    for k in range(cards):
        torch.cuda.synchronize(k)
    sweep_s = time.perf_counter() - t
    cs.same_results(ring_output_to_resultset(out), engine_rs, f"ring on {devices}")
    print(f"ring of 4 positions on {','.join(devices)}: {sweep_s:.3f} s, "
          f"{n * (n - 1) // 2 / sweep_s:,.0f} pairs/s, the engine's rows ({card})", flush=True)
PY
