#!/usr/bin/env python3
"""What the card gives, and what one count launch costs timed every way the
port's records time it, with the SM clock and power sampled beside every
reading.

The twin of ``tools/chip_probe.py``, which asks the same questions of a TPU.
It keeps that tool's three measurements, in its order, at its sizes:

1. ``peak``: the card's matmul rate, the denominator of every
   speed-of-light claim.  ``torch._int_mm`` (int8 -> int32) and a bf16
   ``torch.matmul`` (fp32 accumulation) at M = N = K = 8192, each on the JAX
   tool's operands (``integers(-3, 3)`` of ``default_rng(seed)``,
   ``tools/chip_probe.py:42-62``) and on full-range random ones (int8 over
   [-128, 127], bf16 normal), since on this card the data may set the power.
   Timed by CUDA events over the difference of two run lengths (the JAX
   tool's ``diff_time``, ``:32-39``), the longer run at least
   ``peak_window_s``.  These library calls are the card's yardstick: nothing
   in the port calls them.
2. ``kernel``: the count kernel's indexed entry,
   ``panel_counts_cuda_indexed(planes, 0, (1 + k % 7) * 1024, False, 1024)``,
   on ``[2, 8 * 1024, W]`` planes at ``PlaneLayout.create(100_000)`` (W =
   3,128; the JAX tool's 3,200 is Mosaic's padded width), of three kinds made
   from the seed: ``random`` (``random_planes``), ``cloned`` (the same with
   512 families of 8 clones: the bench's hitful planes cut to 8 panels) and
   ``missing`` (every word all ones, so every site is missing and every
   indicator the kernel multiplies is 0: the same work with the least
   switching in the tensor cores).  Each kind is timed by

   - ``sync``: the host clock over 8 launches, each followed by
     ``torch.cuda.synchronize()`` (``tools/chip_probe.py:86-89``);
   - ``async_x32``: the host clock over 32 queued launches and one sync
     (``:91-94``);
   - ``events_repeat``: CUDA events over a run of one repeated pair, the
     method of ``chip_smoke.py`` phase 2 (``cuda_ms``).  The pair's 51.2 MB
     of planes and 25.2 MB of counters are about the card's 50 MB L2, so
     part of a repeated launch's reads may hit it;
   - ``events_repeat_20``: the same pair at phase 2's own length, 3
     warm-up launches and CUDA events over 20, each round after
     ``idle_s`` (0.5 s) of an idle card, as phase 2 follows host-side
     checks: the ~22 ms run that the longer ones are held against;
   - ``events_cycle8``: CUDA events over a run cycling 8 panels, as
     ``bench_torch.py``'s ``kernel_only`` (205 MB of planes: the reads come
     from HBM);
   - ``diff_1_8``, ``diff_8_32``, ``diff_16_48``: CUDA events differenced
     between cycling runs of the JAX tool's lengths (``:112-115``).

   ``sync``, ``async_x32``, ``events_repeat_20`` and the differences repeat
   in rounds until their window lasts ``min_window_s`` and read the median
   round; the other event runs last ``min_window_s`` each.  Every reading stands beside ``count_bound``, the
   TOP/s it achieves and its share of the bound and of the measured int8
   peak.  On one pair of each kind all six counters must equal the plain
   five-block version (``panel_counts_five_block``); their sum is the JAX
   tool's checksum (``:73-78``).
3. ``engine``: ``KingEngine`` over 16,384 hit-free random samples at
   threshold 0.91 (136 steps, ``tools/torch_trace_report.py``'s shape),
   swept in rounds until ``min_window_s``, each by the host clock ending in
   ``torch.cuda.synchronize()`` and divided by its steps; beside it
   ``events_cycle8`` on the engine's device planes, whose first 8 panels
   are the ``random`` kind's.  The difference is the engine's cost per step
   above the kernel's.

A ``ClockSampler`` (``cuking_tpu_torch/utils/card.py``) samples the card
every 50 ms throughout, and every reading carries the clock record of its
window.  ``--sites 1000000`` runs 2 and 3 at W = 31,252 (2.05 GB of kernel
planes).  ``--quick`` halves every window (``chip_smoke.py`` phase 17).
``--device cpu`` runs tiny sizes through the plain versions, on one thread,
with no window minimum: its times are the host CPU's, no share of a card's rate is
computed, and its clock records read "not measured".  Without a card and
without ``--device cpu`` it exits 2 with the reason and prints no number.

    python3 tools/torch_chip_probe.py [--device cuda|cpu] [--sites N] [--quick] [--seed 0]

Each reading goes to stderr as it is taken, headed by the card's name and
power limit, and every window's clock record after the last.  One JSON line
goes last on stdout.  Exit 0, or 1 when a check fails: counters unequal to
the plain version, a peak above 105% of the data sheet, a window on the card
with no sample, an engine sweep with a hit or without one launch of each
kernel a step.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    matmul: int           # M = N = K of the peak's products
    panel: int
    panels: int           # the kernel's planes hold panels * panel rows
    sites: int
    engine_samples: int
    families: int         # the cloned kind: families of `members` clones
    members: int
    min_window_s: float   # each kernel and engine reading's window, at least
    peak_window_s: float  # each peak's longer run, at least
    idle_s: float         # the card's idle time before each events_repeat_20 round


# tools/chip_probe.py's sizes on the card; tiny ones on the CPU.
CARD = Sizes(8192, 1024, 8, 100_000, 16_384, 512, 8, 1.0, 2.0, 0.5)
CPU = Sizes(256, 64, 8, 2_000, 1024, 8, 4, 0.0, 0.0, 0.0)
KINDS = ("random", "cloned", "missing")
DTYPES = ("int8", "bf16")
OPERANDS = ("small", "full")
SYNC_LAUNCHES, ASYNC_LAUNCHES = 8, 32
PHASE2_WARMUP, PHASE2_LAUNCHES = 3, 20  # chip_smoke.py phase 2's cuda_ms(off, 20, 3)
DIFF_LENGTHS = ((1, 8), (8, 32), (16, 48))
ENGINE_THRESHOLD = 0.91
SAMPLE_MS = 50
PEAK_LIMIT = 1.05  # a rate above this share of the data sheet: the timer is wrong


def kind_planes(kind: str, rows: int, layout, seed: int, families: int,
                members: int) -> np.ndarray:
    """[2, rows, W] uint32 planes of one data kind, made from ``seed``."""
    from cuking_tpu_torch.utils.synthetic import plant_clone_families, random_planes

    if kind == "missing":
        return np.full((2, rows, layout.words), 0xFFFFFFFF, dtype=np.uint32)
    planes = random_planes(rows, layout, np.random.default_rng(seed))
    if kind == "cloned":
        plant_clone_families(planes, [range(f * members, (f + 1) * members)
                                      for f in range(families)])
    return planes


def peak_operand(dtype: str, operands: str, m: int, seed: int, device: str):
    """[m, m] int8 or bf16: the JAX tool's ``integers(-3, 3)``, or full-range
    int8 / normal bf16 (``operands`` "full")."""
    import torch

    rng = np.random.default_rng(seed)
    if operands == "small":
        x = rng.integers(-3, 3, (m, m), dtype=np.int8)
    elif dtype == "int8":
        x = rng.integers(-128, 128, (m, m), dtype=np.int8)
    else:
        x = rng.standard_normal((m, m), dtype=np.float32)
    t = torch.from_numpy(x).to(device)
    return t if dtype == "int8" else t.to(torch.bfloat16)


def matmul_rate(dtype: str, m: int, ms: float) -> tuple[float, float]:
    """(T operations per second, share of the data sheet's peak for
    ``dtype``) of one [m, m] x [m, m] product in ``ms``: 2 m^3 operations."""
    from cuking_tpu_torch.utils.bounds import PEAK_BF16_OPS, PEAK_INT8_OPS

    rate = 2 * m ** 3 / ms / 1e9
    return rate, rate * 1e12 / (PEAK_INT8_OPS if dtype == "int8" else PEAK_BF16_OPS)


def diff_ms(timed, k_short: int, k_long: int) -> float:
    """``tools/chip_probe.py``'s ``diff_time``: the marginal ms per launch
    between a run of ``k_short`` launches and one of ``k_long``
    (``timed(k)``: the ms of a run of k), so that what a run costs once
    cancels.  The caller warms up first."""
    short = timed(k_short)
    return (timed(k_long) - short) / (k_long - k_short)


def checked_pair(planes, panel: int):
    """The count kernel's six counters of the pair (rows [0, panel) x
    [panel, 2 panel)) and their check against the plain five-block version:
    the JAX tool's checksum (the sum of the six), equality, the largest
    difference."""
    import torch

    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed, panel_counts_five_block

    counts = panel_counts_cuda_indexed(planes, 0, panel, False, panel)
    plain = panel_counts_five_block(planes[:, :panel], planes[:, panel:2 * panel])
    got, ref = torch.stack(list(counts)), torch.stack(list(plain))
    return counts, {"checksum": int(got.sum(dtype=torch.int64)),
                    "counters_equal_plain": bool(torch.equal(got, ref)),
                    "max_abs_err": int((got.long() - ref.long()).abs().max())}


class Probe:
    """Times readings on one device, notes each one's window (``time.time()``
    stamps) by its label, and logs each as it is taken."""

    def __init__(self, on_card: bool, log):
        self.on_card = on_card
        self.log = log
        self.spans: dict = {}
        self.readings: dict = {}

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    def event_ms(self, fn) -> float:
        """ms of ``fn()``'s work: CUDA events around it on the card, the host
        clock on the CPU."""
        if not self.on_card:
            t = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t)
        import torch

        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    def host_ms(self, fn, n: int) -> float:
        """Host-clock ms per launch of ``fn()`` (n launches, ending in a sync)."""
        t = time.perf_counter()
        fn()
        self.sync()
        return 1e3 * (time.perf_counter() - t) / n

    def reading(self, label: str, measure, min_s: float, **extra) -> dict:
        """Calls ``measure()`` (ms) in rounds until ``min_s`` seconds have
        passed (once at least) and keeps the median round."""
        t0, wall, runs = time.time(), time.perf_counter(), []
        while not runs or time.perf_counter() - wall < min_s:
            runs.append(measure())
        self.spans[label] = (t0, time.time())
        r = {"ms": statistics.median(runs), "ms_min": min(runs), "ms_max": max(runs),
             "rounds": len(runs), **extra}
        self.readings[label] = r
        self.log(f"{label}: {r['ms']:.4f} ms (median of {len(runs)}; "
                 f"{r['ms_min']:.4f}-{r['ms_max']:.4f})")
        return r


def peak_section(probe: Probe, sizes: Sizes, seed: int, device: str) -> tuple[dict, list]:
    import torch

    m, peak, failures = sizes.matmul, {}, []
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        for dtype in DTYPES:
            for operands in OPERANDS:
                a = peak_operand(dtype, operands, m, seed, device)
                at = a.t()
                product = (lambda: torch._int_mm(a, at)) if dtype == "int8" else (
                    lambda: torch.matmul(a, at))

                def timed(k, product=product):
                    def run():
                        for _ in range(k):
                            product()  # each result freed before the next is made
                    return probe.event_ms(run)

                timed(2)  # warm-up: the library picks its kernel on the first call
                est = timed(8) / 8
                k_long = max(8, math.ceil(sizes.peak_window_s * 1e3 / est))
                k_short = k_long // 4
                label = f"peak/{dtype}/{operands}"
                r = probe.reading(label, lambda: diff_ms(timed, k_short, k_long), 0.0,
                                  k_short=k_short, k_long=k_long)
                rate, share = matmul_rate(dtype, m, r["ms"])
                r.update(dtype=dtype, operands=operands,
                         unit="TOP/s" if dtype == "int8" else "TFLOP/s",
                         rate=rate if probe.on_card else None,
                         share_of_datasheet=share if probe.on_card else None)
                peak.setdefault(dtype, {})[operands] = r
                if probe.on_card:
                    probe.log(f"{label}: {r['ms']:.4f} ms per {m}^3 -> {rate:.1f} {r['unit']}, "
                              f"{100 * share:.1f}% of the data sheet")
                    if share > PEAK_LIMIT:
                        failures.append(f"{label}: {rate:.1f} {r['unit']} is above "
                                        f"{PEAK_LIMIT:.0%} of the data sheet")
                del a, at
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return peak, failures


def kernel_readings(probe: Probe, label: str, planes, sizes: Sizes, extra: dict,
                    methods=None) -> dict:
    """Times the count kernel on ``planes`` by each method (all by default)."""
    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed

    p, cycle = sizes.panel, sizes.panels - 1

    def run(n: int, repeat: bool = False) -> None:
        for k in range(n):
            panel_counts_cuda_indexed(planes, 0, p if repeat else (1 + k % cycle) * p, False, p)

    run(cycle)  # warm-up
    probe.sync()
    win, out = sizes.min_window_s, {}
    methods = methods or ("sync", "async_x32", "events_repeat", "events_repeat_20",
                          "events_cycle8") + tuple(f"diff_{s}_{l}" for s, l in DIFF_LENGTHS)
    est = probe.host_ms(lambda: run(ASYNC_LAUNCHES), ASYNC_LAUNCHES)
    n = max(ASYNC_LAUNCHES, math.ceil(win * 1e3 / est))

    def sync_round():
        t = time.perf_counter()
        for k in range(SYNC_LAUNCHES):
            panel_counts_cuda_indexed(planes, 0, (1 + k % cycle) * p, False, p)
            probe.sync()
        return 1e3 * (time.perf_counter() - t) / SYNC_LAUNCHES

    def phase2_round():
        time.sleep(sizes.idle_s)
        run(PHASE2_WARMUP, repeat=True)
        probe.sync()
        return probe.event_ms(lambda: run(PHASE2_LAUNCHES, repeat=True)) / PHASE2_LAUNCHES

    measures = {
        "sync": (sync_round, win, {}),
        "async_x32": (lambda: probe.host_ms(lambda: run(ASYNC_LAUNCHES), ASYNC_LAUNCHES),
                      win, {}),
        "events_repeat": (lambda: probe.event_ms(lambda: run(n, repeat=True)) / n, 0.0,
                          {"launches": n}),
        "events_repeat_20": (phase2_round, win, {"launches": PHASE2_LAUNCHES,
                                                 "idle_s": sizes.idle_s}),
        "events_cycle8": (lambda: probe.event_ms(lambda: run(n)) / n, 0.0, {"launches": n}),
    }
    for s, l in DIFF_LENGTHS:
        measures[f"diff_{s}_{l}"] = (
            lambda s=s, l=l: diff_ms(lambda k: probe.event_ms(lambda: run(k)), s, l), win,
            {"k_short": s, "k_long": l})
    for method in methods:
        measure, min_s, more = measures[method]
        out[method] = probe.reading(f"{label}/{method}", measure, min_s, **more, **extra)
    return out


def bound_fields(sizes: Sizes, words: int) -> dict:
    from cuking_tpu_torch.utils.bounds import count_bound

    return dict(zip(("bound_ms", "bound_by"), count_bound(sizes.panel, sizes.panel, words)))


def rate_fields(reading: dict, ops: int, int8_peak: float | None, on_card: bool) -> None:
    """The achieved TOP/s of a count reading and its shares of the bound and
    of the measured int8 peak (none on the CPU)."""
    tops = ops / reading["ms"] / 1e9
    reading.update(
        tops=tops if on_card else None,
        share_of_bound=reading["bound_ms"] / reading["ms"] if on_card else None,
        share_of_measured_int8=tops / int8_peak if on_card and int8_peak else None)


def engine_section(probe: Probe, sizes: Sizes, seed: int, device: str) -> tuple[dict, list]:
    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.stopwatch import StageLogger
    from cuking_tpu_torch.utils.synthetic import fill_random_planes
    from tools.torch_trace_report import launch_counts

    layout = PlaneLayout.create(sizes.sites)
    storage = PanelStorage(layout, Submatrix.create(sizes.engine_samples, 1, 0), sizes.panel)
    fill_random_planes(storage.planes, layout, np.random.default_rng(seed))
    engine = KingEngine(storage, KingConfig(kin_threshold=ENGINE_THRESHOLD, panel=sizes.panel,
                                            device=device), logger=StageLogger(enabled=False))
    panels = sizes.engine_samples // sizes.panel
    steps = panels * (panels + 1) // 2
    engine.run()  # warm-up, and the planes' upload
    probe.sync()
    hits = []

    def sweep():
        t = time.perf_counter()
        hits.append(len(engine.run()))
        probe.sync()
        return 1e3 * (time.perf_counter() - t) / steps

    before = launch_counts()
    r = probe.reading("engine/sweep", sweep, sizes.min_window_s, steps=steps)
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    failures = []
    if any(hits):
        failures.append(f"engine: a hit-free sweep returned {max(hits)} hits")
    if probe.on_card and any(v != steps * r["rounds"] for v in launches.values()):
        failures.append(f"engine: {launches} launches over {r['rounds']} sweeps of {steps} steps")
    cycle = kernel_readings(probe, "engine/kernel", engine.planes_dev, sizes,
                            bound_fields(sizes, layout.words),
                            methods=("events_cycle8",))["events_cycle8"]
    out = {"samples": sizes.engine_samples, "sites": sizes.sites, "threshold": ENGINE_THRESHOLD,
           "steps": steps, "sweep": r, "kernel_events_cycle8": cycle, "hits": max(hits),
           "launches": launches, "step_ms": r["ms"], "kernel_ms": cycle["ms"],
           "above_kernel_ms": r["ms"] - cycle["ms"]}
    probe.log(f"engine: {r['ms']:.4f} ms a step ({steps} steps, {r['rounds']} sweeps), the "
              f"kernel {cycle['ms']:.4f} ms a launch on its planes: "
              f"{out['above_kernel_ms']:.4f} ms a step above it")
    return out, failures


def clock_line(label: str, rec: dict) -> str:
    if rec.get("note"):
        return f"{label}: {rec['note']}"
    return (f"{label}: SM {rec['sm_mhz_median']}/{rec['sm_mhz_min']} MHz (median/min), mem "
            f"{rec['mem_mhz_median']} MHz, power {rec['power_w_median']}/{rec['power_w_max']} W "
            f"(instant {rec['power_instant_w_median']}/{rec['power_instant_w_max']}), "
            f"{rec['temperature_c_max']} C, reasons {rec['reasons_active']}; "
            f"{rec['samples']} samples {rec['spacing_ms']} ms apart")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sites", type=int, default=None,
                    help="sites of the kernel's and the engine's planes (default 100,000)")
    ap.add_argument("--quick", action="store_true", help="halve every window")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.utils import card
    from cuking_tpu_torch.utils.bounds import count_ops
    from tools.torch_trace_report import launch_counts

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_chip_probe: no CUDA device (torch.cuda.is_available() is false); "
              "pass --device cpu for a CPU check at small sizes", file=sys.stderr)
        return 2
    sizes = CARD if on_card else CPU
    if args.sites:
        sizes = dataclasses.replace(sizes, sites=args.sites)
    if args.quick:
        sizes = dataclasses.replace(sizes, min_window_s=sizes.min_window_s / 2,
                                    peak_window_s=sizes.peak_window_s / 2)
    if on_card:
        torch.cuda.set_device(0)
        name = card.card_name()
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
        sampler = card.ClockSampler(card.smi_id(torch.cuda.get_device_properties(0)),
                                    interval_ms=SAMPLE_MS)
    else:
        # Tiny sizes: one thread.  With a pool per core, runs in parallel
        # processes (the test workers) wait on each other's spinning threads.
        torch.set_num_threads(1)
        name = "no card (cpu): the host CPU's times, no device number"
        device = {"platform": "cpu", "kind": "cpu", "count": 0}
        sampler = None

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    log(f"{name}; torch {torch.__version__}; CUDA {torch.version.cuda}; {sizes}")
    probe = Probe(on_card, log)
    layout = PlaneLayout.create(sizes.sites)
    rows = sizes.panels * sizes.panel
    start = launch_counts()
    failures, kernel = [], {}
    with sampler or contextlib.nullcontext():
        peak, failed = peak_section(probe, sizes, args.seed, args.device)
        failures += failed
        extra = bound_fields(sizes, layout.words)
        for kind in KINDS:
            planes = torch.from_numpy(kind_planes(kind, rows, layout, args.seed, sizes.families,
                                                  sizes.members).view(np.int32)).to(args.device)
            _, check = checked_pair(planes, sizes.panel)
            if not check["counters_equal_plain"]:
                failures.append(f"kernel/{kind}: the counters differ from the plain version "
                                f"by up to {check['max_abs_err']}")
            log(f"kernel/{kind}: checksum {check['checksum']}, six counters equal the plain "
                f"version: {check['counters_equal_plain']}")
            kernel[kind] = {**check, "methods": kernel_readings(probe, f"kernel/{kind}",
                                                                 planes, sizes, extra)}
            del planes
        engine, failed = engine_section(probe, sizes, args.seed, args.device)
        failures += failed
    end = launch_counts()

    int8 = min(peak["int8"].values(), key=lambda r: r["ms"])  # the card's best int8 rate
    int8_peak = int8["rate"]
    ops = count_ops(sizes.panel, sizes.panel, layout.words)
    for kind in KINDS:
        for r in kernel[kind]["methods"].values():
            rate_fields(r, ops, int8_peak, on_card)
    rate_fields(engine["kernel_events_cycle8"], ops, int8_peak, on_card)
    windows = {}
    for label, (t0, t1) in probe.spans.items():
        rec = sampler.window(t0, t1) if sampler else card.not_measured(
            "no card: a run on the host CPU")
        windows[label] = probe.readings[label]["clock"] = rec
        if on_card and rec["samples"] == 0:
            failures.append(f"{label}: no clock sample in its window")
        log(clock_line(label, rec))
    for f in failures:
        log(f"FAIL: {f}")
    print(json.dumps({
        "card": name, "torch": torch.__version__, "cuda": torch.version.cuda, "device": device,
        "seed": args.seed, "sizes": dataclasses.asdict(sizes), "words": layout.words,
        "timer": ("CUDA events (peak, events_*, diff_*); host clock ending in a sync (sync, "
                  "async_x32, engine)" if on_card else "the host CPU's clock: no device number"),
        "clock_fields": sampler.fields if sampler else None,
        "sample_interval_ms": SAMPLE_MS if sampler else None,
        "peak": peak,
        "measured_int8_peak": {"rate": int8_peak, "operands": int8["operands"]},
        "kernel": kernel, "engine": engine,
        "launches_total": {k: end[k] - start[k] for k in end},
        "checks_failed": failures, "windows": windows,
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
