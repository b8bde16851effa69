"""Runs one cell of ``BENCHMARK.json`` on its NVIDIA H100s (one card, or
the cell's ``chips`` cards of one host) and prints one JSON line last.

    python kingbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``kingbench/configs/<config>.json``) and a
traffic file (``kingbench/workloads/<traffic>.json``), whose ``mode``
names the window driver (``kingbench/modes/<mode>.py``); each per-layer
metric is read by ``kingbench/metrics/<metric>.py``.  All are found by
name, so a new cell or metric adds files and edits none.

Set-up (``setup_s``, from this file's first line to the window's start)
covers the imports, the CUDA context on each of the cell's cards, loading
the port's kernel library and native packer (built inside the checkout on
a first run), making the inputs from ``--seed`` and one warm unit.  The
window then runs whole units (a sweep, or a task), one after another,
until ``--seconds`` have passed, each ending on the host with every card
of the cell synchronised.  A mode is handed its cards as the CLI's
``--device`` takes them: ``cuda`` for one, ``cuda:0,cuda:1,...`` for
several.  The peak device memory is the fullest card's, and a traced
run's busy time is a card's mean (a card with no device operation counts
as idle).  With ``--trace 1`` the window runs under ``torch.profiler`` and
the line holds the per-layer metrics; with ``--trace 0`` the end-to-end
ones.  After the window the port's state is dropped, the reference
recomputes the shard, and every output of the window is compared with it
(``check.py``): the numbers compared, each beside its limit, are the last
lines on standard error and the last key of the line.

Exits 2 without a card (or with fewer than the cell asks for), 3 when a
module of JAX or of the JAX package was loaded, 1 on an error; in each case
it prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "kingbench")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Top-level module names that no run may load: JAX and the JAX package,
# which the port's name begins with.
FORBIDDEN = ("jax", "jaxlib", "flax", "cuking_tpu")


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of :data:`FORBIDDEN`, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(manifest: dict, name: str) -> tuple[dict, dict, dict]:
    """(the cell's entry, its configuration, its traffic) by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return (cell, load_json(REPO, config["file"]),
            load_json(HERE, "workloads", cell["traffic"] + ".json"))


def metrics_of(manifest: dict, section: str, cell: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read(ctx)`` of ``kingbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"kingbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return "; ".join(out.stdout.strip().splitlines()) or out.stderr.strip()


def cards(device: str, chips: int) -> list[str]:
    """The devices of a cell of ``chips`` cards: ``device`` itself for one;
    for several, ``cuda:0`` ... ``cuda:{chips - 1}``.  A mode gets them
    joined by commas, as ``--device`` takes them."""
    if chips == 1:
        return [device]
    return [f"cuda:{k}" for k in range(chips)]


def synchronize(devices: list[str]) -> None:
    """Waits until every one of the cards has finished its work."""
    import torch

    for d in devices:
        torch.cuda.synchronize(d)


def memory_peak(devices: list[str]) -> tuple[int, dict]:
    """(the fullest card's peak device memory, each card's), in bytes,
    since their last reset."""
    import torch

    peaks = {d: torch.cuda.max_memory_allocated(d) for d in devices}
    return max(peaks.values()), peaks


def run_cell(manifest: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0, spec: tuple | None = None) -> dict:
    """Runs the cell on its cards and returns its result (without the
    import check); ``spec`` gives (cell, configuration, traffic) in place
    of the files."""
    import torch

    from kingbench import check, tracing

    cell, config, traffic = spec or cell_spec(manifest, name)
    mode = importlib.import_module(f"kingbench.modes.{traffic['mode']}")
    chips = cell["chips"]
    devices = cards(device, chips)
    cuda = torch.device(device).type == "cuda"
    stamps = [("imports", time.perf_counter())]
    if cuda:
        for d in devices:
            torch.empty(1, device=d)
    stamps.append(("cuda context", time.perf_counter()))
    session = mode.Session(config, traffic, seed, ",".join(devices))
    stamps.append(("data", time.perf_counter()))
    try:
        if not session.ok(session.once()):  # the warm unit
            raise RuntimeError(f"the warm {session.unit} failed")
        if cuda:
            synchronize(devices)
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
        stamps.append((f"warm {session.unit}", time.perf_counter()))
        setup_s = time.perf_counter() - t0
        split = [(k, b - a) for (k, b), (_, a) in zip(stamps, [("", t0)] + stamps)]
        print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in split), file=sys.stderr)
        outputs, marks = [], []
        with tracing.profiled(trace, cuda) as prof:
            start = time.perf_counter()
            while True:
                a = time.perf_counter()
                with tracing.unit_marker() if trace else contextlib.nullcontext():
                    out = session.once()
                if cuda:
                    synchronize(devices)
                b = time.perf_counter()
                outputs.append(out)
                marks.append((a, b))
                if b - start >= seconds or not session.ok(out):
                    break
            wall = time.perf_counter() - start
        peak, peaks = memory_peak(devices) if cuda else (0, {})
        failed = sum(1 for o in outputs if not session.ok(o))
        done = len(outputs) - failed

        result = {"attempted": len(outputs), "failed": failed}
        if trace:
            ctx = _trace_context(session, prof["trace"], outputs, marks, wall, traffic["mode"],
                                 chips)
            device_info = {"busy_s": tracing.mean_busy_ms(ctx["trace"], chips) / 1e3,
                           "window_s": ctx["trace"]["trace_span_ms"] / 1e3}
            values = {}
            for m in metrics_of(manifest, "per_layer", name):
                v = reader(m["name"])(ctx)
                if v is not None:
                    values[m["name"]] = {"value": v, "unit": m["unit"]}
            result["breakdown"] = ctx["breakdown"]
        else:
            device_info = {}
            measured = dict(session.end_to_end(done, wall) if done else {})
            measured["setup_s"] = setup_s
            measured["peak_device_gib"] = peak / (1 << 30)
            values = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                      for m in metrics_of(manifest, "end_to_end", name) if m["name"] in measured}
        result["metrics"] = values
        result["device"] = {"platform": "gpu" if cuda else "cpu",
                            "kind": torch.cuda.get_device_name() if cuda else "cpu",
                            "count": chips, "memory_peak_bytes": int(peak), **device_info}
        if cuda:
            print(f"card: {power_limit()}", file=sys.stderr)
            print("peak per card: " + ", ".join(f"{d} {p} B" for d, p in peaks.items()),
                  file=sys.stderr)
        print(f"window: {done} {session.unit}s in {wall:.3f} s: "
              + " ".join(f"{b - a:.3f}" for a, b in marks), file=sys.stderr)
        notes = session.notes(outputs)
        if notes:
            print(f"stages: {notes}", file=sys.stderr)

        # The port's state goes before the reference runs, so that the
        # reference neither sets the peak nor lacks room.
        got = session.outputs_rows(outputs)
        del outputs
        session.free()
        t = time.perf_counter()
        want = session.reference()
        print(f"reference: {len(want)} rows in {time.perf_counter() - t:.3f} s", file=sys.stderr)
        numbers = check.total([check.compare(g, want) for g in got if g is not None])
        result["correct"] = failed == 0 and done > 0 and check.correct(numbers)
        result["checks"] = {k: {"value": numbers[k], "limit": check.LIMITS[k]}
                            for k in check.NUMBERS}
        return result
    finally:
        session.close()


def _trace_context(session, trace: dict, outputs: list, marks: list, wall: float,
                   mode: str, chips: int) -> dict:
    """What the per-layer readers read: the frozen ``analyze``'s reading,
    the units done, the window's wall time, the cell's cards, the mode's
    own context, and the breakdown of device operations and labelled idle
    gaps (stretches in which no card ran anything)."""
    from kingbench import tracing

    stats, events, window = tracing.read_window(trace)
    units = sum(1 for o in outputs if session.ok(o))
    ctx = {"trace": stats, "units": units, "wall_s": wall, "mode": mode, "chips": chips}
    ctx.update(session.layer_context(outputs))
    spans = tracing.host_spans(trace)
    # Host clock (s) → trace clock (us), from the first unit's annotation.
    offset = spans[0][0] - marks[0][0] * 1e6 if spans else 0.0
    stage_spans = [[(a * 1e6 + offset, b * 1e6 + offset, s) for a, b, s in unit]
                   for unit in ctx.get("stage_spans", [])]

    def label(t: float) -> str:
        for k, (s, e) in enumerate(spans):
            if s <= t <= e:
                if mode == "sweep":
                    return "inside a sweep"
                stage = [n for a, b, n in (stage_spans[k] if k < len(stage_spans) else [])
                         if a <= t <= b]
                return stage[0] if stage else "inside a task, between stages"
        return f"between {session.unit}s"

    ctx["breakdown"] = {"device_ops": tracing.device_ops(events),
                        "idle_gaps": tracing.idle_gaps(events, window, label) if window else []}
    return ctx


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest = load_json(REPO, "BENCHMARK.json")
    chips = next((w["chips"] for w in manifest["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kingbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules(list(sys.modules))
    if loaded:
        print(f"kingbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    line = {"correct": result.pop("correct"), **result, "checks": checks}
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
