"""The control of a cell: the reference put in the port's place, run a
precision below the configuration's, must come out not correct.

    python kingbench/control.py --workload <cell> --seeds <n>,<n>,<n>

The configuration states kin in float32 (bit for bit as cuKING and Hail's
``hl.king``); the control computes the same counts exactly and kin in
bfloat16, the next precision down, then goes through the comparison that
decides ``correct`` (``check.py``) against the float32 reference, on the
cell's own inputs at its own size.  One JSON line per seed, then one with
the least reading of each number over the seeds (the upper readings of the
limits).  The benchmark's own runs do not run it.  Exits 2 without a card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from kingbench import check, run  # noqa: E402


def readings(config: dict, traffic: dict, seed: int, device: str) -> dict:
    """The comparison's numbers for the control on one seed."""
    mode = importlib.import_module(f"kingbench.modes.{traffic['mode']}")
    want = mode.reference_rows(config, traffic, seed, device)
    got = mode.reference_rows(config, traffic, seed, device, dtype=torch.bfloat16)
    numbers = check.compare(got, want)
    return {"seed": seed, "rows": len(want), "control_rows": len(got), **numbers,
            "correct": check.correct(numbers)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    manifest = run.load_json(run.REPO, "BENCHMARK.json")
    _, config, traffic = run.cell_spec(manifest, args.workload)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(config, traffic, seed, args.device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        out.append(r)
    print(json.dumps({"workload": args.workload, "seeds": len(out),
                      "least": {k: min(r[k] for r in out) for k in check.NUMBERS},
                      "any_correct": any(r["correct"] for r in out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
