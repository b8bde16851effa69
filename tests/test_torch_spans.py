"""The port's spans (``cuking_tpu_torch/utils/stopwatch.py``) on the CPU: none
recorded and no annotation entered without a profiler, and no flag read in
the step loop; under ``torch.profiler`` a tiny CLI task's root, stages,
ingest phases on worker threads and engine spans, each on the clock of the
exported Chrome trace; the CLI's stdout unchanged by the profiler; the
``--profile_dir`` trace of the whole task with ingest's spans added as
complete events that the trace reader keeps out of device time; every span
of the port's table recorded with its counts.  The benchmark's readers of
these spans are tested beside them, in ``kingbench/tests``."""

import contextlib
import gc
import json
import math
import os
import re
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuking_tpu_torch import cli
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models import king
from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils import stopwatch, trace
from cuking_tpu_torch.utils.synthetic import random_genotypes

SAMPLES, SITES, FILES, PANEL = 600, 400, 3, 128
STAGES = ["metadata", "allocate", "listing", "ingest", "king_kernel", "write"]
INGEST = ["ingest.read", "ingest.decode", "ingest.filter", "ingest.scatter"]
# Every span the port records, with the keys of the counts it carries.
TABLE = {
    "cli.task": {"shard_index"}, **{f"stage.{k}": set() for k in STAGES},
    "ingest.read": {"bytes"}, "ingest.decode": {"entries"}, "ingest.filter": {"kept"},
    "ingest.scatter": set(), "engine.run": {"sweeps"}, "engine.upload": {"bytes"},
    "engine.schedule": {"steps"}, "engine.steps": {"steps"}, "engine.limit_wait": set(),
    "engine.count_read": {"total"}, "engine.fetch": {"rows"}, "engine.sort": set(),
}


class Writes:
    """A text stream that keeps each write."""

    def __init__(self):
        self.writes: list[str] = []

    def write(self, text: str) -> int:
        self.writes.append(text)
        return len(text)

    def flush(self) -> None:
        pass


@pytest.fixture(scope="module")
def input_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "input")
    g = random_genotypes(SAMPLES, SITES, missing_rate=0.05, seed=7, num_related_pairs=3)
    write_synthetic_input(Storage(), path, g, num_partitions=FILES)
    return path


def argv(input_dir: str, out: str, *extra: str) -> list[str]:
    # Split 2 shard 0 is block (0, 0): the filter drops half the entries.
    return ["--input_uri", input_dir, "--output_uri", out, "--device", "cpu",
            "--kin_threshold", "0.05", "--split_factor", "2", "--shard_index", "0",
            "--panel", str(PANEL), *extra]


def run_cli(args: list[str], traced: bool, chrome: str | None = None) -> list[str]:
    """The CLI's stdout writes; under a CPU profiler when ``traced``, its
    trace exported to ``chrome``."""
    out = Writes()
    cpu = [ProfilerActivity.CPU]
    with profile(activities=cpu) if traced else contextlib.nullcontext() as prof:
        with contextlib.redirect_stdout(out):
            assert cli.main(args) == 0
    if chrome:
        prof.export_chrome_trace(chrome)
    return out.writes


@pytest.fixture(scope="module")
def traced_task(input_dir, tmp_path_factory):
    """(the spans of one traced CLI task, its Chrome trace, its stdout
    writes, the id of the thread it ran on)."""
    tmp = tmp_path_factory.mktemp("traced")
    stopwatch.clear()
    path = str(tmp / "trace.json")
    # No collection pause between a span's stamp and its annotation's edge,
    # and not the process's first annotation, whose enter sets the profiler's
    # operators up (~1 ms): the clock test compares the two edges.
    with profile(activities=[ProfilerActivity.CPU]), stopwatch.span("warm"):
        pass
    stopwatch.clear()
    gc.disable()
    try:
        writes = run_cli(argv(input_dir, str(tmp / "out")), True, path)
    finally:
        gc.enable()
    with open(path) as f:
        chrome = json.load(f)
    spans = stopwatch.recorded()
    stopwatch.clear()
    return spans, chrome, writes, threading.get_native_id()


def named(spans, name):
    return [s for s in spans if s.name == name]


def normalized(writes: list[str]) -> list[str]:
    """The writes with their times and the output directory left out."""
    return [re.sub(r"Wrote .*/(part-\d+)", r"Wrote OUT/\1",
                   re.sub(r"\(\d+\.\d{3}s\)", "(Ts)", w)) for w in writes]


def test_no_profiler_records_no_span_and_enters_no_annotation(input_dir, tmp_path,
                                                              monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    stopwatch.clear()
    run_cli(argv(input_dir, str(tmp_path / "out")), False)
    assert stopwatch.recorded() == [] and calls == []
    assert stopwatch.current() is stopwatch.OFF


def engine_of(samples: int, panel: int = 16, sites: int = 64) -> KingEngine:
    """A tiny CPU engine whose every pair is a hit."""
    g = random_genotypes(samples, sites, missing_rate=0.05, seed=3, num_related_pairs=2)
    return KingEngine.from_genotypes(g, KingConfig(panel=panel, device="cpu",
                                                   kin_threshold=-1.0))


def test_the_step_loop_reads_no_flag_per_step(monkeypatch):
    """A count copy and a wait at every step: sweeps of 10 and 55 steps make
    the same number of tracing checks, untraced and traced."""
    monkeypatch.setattr(king, "LIMIT_CHECK_STEPS", 1)
    monkeypatch.setattr(king, "LIMIT_CHECK_WINDOW", 1)
    reads = []
    real = torch.autograd._profiler_enabled

    def counting():
        reads.append(1)
        return real()

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", counting)
    per_run = {}
    for samples in (64, 160):
        engine = engine_of(samples)
        steps = len(engine._panel_pair_params())
        engine.run()  # uploads
        reads.clear()
        engine.run()
        per_run[steps] = len(reads)
    assert sorted(per_run) == [10, 55]
    assert per_run[10] == per_run[55] <= 8
    stopwatch.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.run()
    waits = named(stopwatch.recorded(), "engine.limit_wait")
    (loop,) = named(stopwatch.recorded(), "engine.steps")
    assert len(waits) >= 50 and all(w.parent == loop.id for w in waits)
    stopwatch.clear()


def test_a_traced_task_records_its_root_and_stages_in_order(traced_task):
    spans, _, _, main = traced_task
    (root,) = named(spans, "cli.task")
    assert root.parent is None and root.root == root.id and root.tid == main
    assert root.counts == {"shard_index": 0}
    stages = [s for s in spans if s.name.startswith("stage.")]
    assert [s.name for s in stages] == [f"stage.{k}" for k in STAGES]
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    for s in spans:
        assert s.root == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert len({s.id for s in spans}) == len(spans)


def test_ingest_phases_run_on_workers_under_the_ingest_stage(traced_task):
    spans, _, _, main = traced_task
    (stage,) = named(spans, "stage.ingest")
    for name in INGEST:
        phase = named(spans, name)
        assert len(phase) == FILES, name
        assert all(s.parent == stage.id and s.tid != main for s in phase), name
        assert all(stage.start_ns <= s.start_ns <= s.end_ns <= stage.end_ns for s in phase)
    assert all(s.counts["bytes"] > 0 for s in named(spans, "ingest.read"))
    # On each decode thread a file's decode, filter and scatter follow in turn.
    entries = kept = 0
    for tid in {s.tid for s in named(spans, "ingest.decode")}:
        decodes = [s for s in named(spans, "ingest.decode") if s.tid == tid]
        filters = [s for s in named(spans, "ingest.filter") if s.tid == tid]
        for d, f in zip(decodes, filters):
            assert d.end_ns <= f.start_ns and f.counts["kept"] <= d.counts["entries"]
            entries += d.counts["entries"]
            kept += f.counts["kept"]
    assert 0 < kept < entries


def test_the_engine_records_its_upload_and_step_loop(traced_task):
    spans, _, _, _ = traced_task
    storage = PanelStorage(PlaneLayout.create(SITES), Submatrix.create(SAMPLES, 2, 0),
                           PANEL)
    engine = KingEngine(storage, KingConfig(panel=PANEL, device="cpu"))
    steps = len(engine._panel_pair_params())
    (upload,) = named(spans, "engine.upload")
    assert upload.counts == {"bytes": storage.planes.nbytes}
    (loop,) = named(spans, "engine.steps")
    (schedule,) = named(spans, "engine.schedule")
    assert loop.counts == schedule.counts == {"steps": steps} and steps > 1
    (run,) = named(spans, "engine.run")
    assert run.counts == {"sweeps": 1}
    (read,) = named(spans, "engine.count_read")
    (fetch,) = named(spans, "engine.fetch")
    assert read.counts["total"] == fetch.counts["rows"] > 0
    assert len(named(spans, "engine.sort")) == 1
    assert run.start_ns <= upload.start_ns <= loop.start_ns <= read.start_ns <= run.end_ns


def test_main_thread_spans_are_annotations_on_the_trace_clock(traced_task):
    spans, chrome, _, main = traced_task
    base = chrome["baseTimeNanoseconds"]
    annotations: dict = {}
    for e in chrome["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            annotations.setdefault(e["name"], []).append(e)
    mine = [s for s in spans if s.tid == main]
    assert len(mine) >= 13
    for s in mine:
        events = sorted(annotations.get(s.name, []), key=lambda e: e["ts"])
        same = [x for x in mine if x.name == s.name]
        e = events[same.index(s)]
        start = e["ts"] * 1e3 + base
        assert abs(start - s.start_ns) < 1e6, s.name
        # Each edge is stamped just before the annotation's call: the
        # annotation starts and ends no earlier than the span.
        assert start >= s.start_ns - 1e6, s.name
        assert start + e["dur"] * 1e3 >= s.end_ns - 1e6, s.name
    # The profiler keeps no annotation made on a worker thread.
    assert not any(name in annotations for name in INGEST)


def test_stdout_is_unchanged_by_the_profiler(input_dir, tmp_path, traced_task):
    _, _, traced, _ = traced_task
    plain = run_cli(argv(input_dir, str(tmp_path / "a")), False)
    assert normalized(plain) == normalized(traced)
    # Quiet, the stages print nothing and are recorded all the same.
    stopwatch.clear()
    assert run_cli(argv(input_dir, str(tmp_path / "b"), "--quiet"), True) == []
    names = [s.name for s in stopwatch.recorded() if s.name.startswith("stage.")]
    assert names == [f"stage.{k}" for k in STAGES]
    stopwatch.clear()


def test_a_stage_that_raises_is_closed_with_its_task(tmp_path):
    stopwatch.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with contextlib.redirect_stdout(Writes()):
            rc = cli.main(["--input_uri", str(tmp_path / "missing"), "--output_uri",
                           str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 1
    spans = stopwatch.recorded()
    assert [s.name for s in spans] == ["cli.task", "stage.metadata"]
    assert spans[1].end_ns <= spans[0].end_ns
    assert stopwatch.current() is stopwatch.OFF
    stopwatch.clear()


def test_profile_dir_traces_the_whole_task_with_ingest_spans(input_dir, tmp_path):
    traces = tmp_path / "traces"
    stopwatch.clear()
    run_cli(argv(input_dir, str(tmp_path / "out"), "--profile_dir", str(traces)), False)
    spans = stopwatch.recorded()
    stopwatch.clear()
    path = str(traces / "trace-part-00000.json")
    with open(path) as f:
        chrome = json.load(f)
    events = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"cli.task", "engine.upload"} | {f"stage.{k}" for k in STAGES} <= annotated
    # Every span of the task is added, with its ids and counts: the main
    # thread's beside their annotations, the workers' alone.
    added = [e for e in events if e.get("cat") == stopwatch.CHROME_CAT]
    assert sorted(e["name"] for e in added) == sorted(s.name for s in spans)
    assert sorted(e["name"] for e in added if e["name"] not in annotated) == sorted(
        INGEST * FILES)
    base = chrome["baseTimeNanoseconds"]
    for e, s in zip(added, spans):
        assert e["name"] == s.name and e["tid"] == s.tid and e["pid"] == os.getpid()
        assert e["ts"] == (s.start_ns - base) / 1e3
        assert e["args"] == {"id": s.id, "parent": s.parent, "root": s.root, **s.counts}
    (task,) = [e for e in added if e["name"] == "cli.task"]
    assert task["args"]["shard_index"] == 0
    (steps,) = [e for e in added if e["name"] == "engine.schedule"]
    (read,) = [e for e in added if e["name"] == "engine.count_read"]
    (fetch,) = [e for e in added if e["name"] == "engine.fetch"]
    assert steps["args"]["steps"] > 1 and read["args"]["total"] == fetch["args"]["rows"] > 0
    for e in added:
        assert task["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= task["ts"] + task["dur"] + 1e-3
        assert e["args"]["root"] == task["args"]["id"]
    device, _, _ = trace.read(path)
    assert device == []


def write_trace(path: str, text: str) -> str:
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("events", ["", '{"ph": "X", "name": "a]", "ts": 1, "dur": 2}'])
def test_append_events_adds_to_the_end_of_trace_events(tmp_path, events, monkeypatch):
    """A trace streamed through in small pieces: its own events kept, the
    added ones after them on the trace's base, a ``]`` in a name or in the
    trace's name no end of the list."""
    monkeypatch.setattr(trace, "_EDGE_BYTES", 64)
    src = write_trace(str(tmp_path / "t.json"), (
        '{"schemaVersion": 1, "baseTimeNanoseconds": 5000,\n "traceEvents": [\n'
        + events + '\n ], "traceName": "x]/trace.json" }'))
    bases = []

    def added(base):
        bases.append(base)
        return [{"ph": "X", "name": "b", "ts": 2, "dur": 1}]

    dst = tmp_path / "out.json"
    with open(dst, "wb") as f:
        trace.append_events(src, f, added)
    out = json.loads(dst.read_text())
    assert bases == [5000]
    assert [e["name"] for e in out["traceEvents"]] == ["a]"] * bool(events) + ["b"]
    assert out["traceName"] == "x]/trace.json" and out["schemaVersion"] == 1


def test_append_events_refuses_a_trace_without_its_base(tmp_path):
    src = write_trace(str(tmp_path / "t.json"), '{"traceEvents": [], "traceName": "t"}')
    with open(tmp_path / "out.json", "wb") as f, pytest.raises(ValueError, match="base"):
        trace.append_events(src, f, lambda base: [])


def test_the_trace_reader_keeps_spans_out_of_device_time(tmp_path):
    span = stopwatch.Span("ingest.decode", 2, 1, 1, 99, start_ns=5_000, end_ns=905_000,
                          counts={"entries": 10})
    events = [{"ph": "X", "cat": "kernel", "name": "king_counts_wgmma_kernel", "ts": 100,
               "dur": 300, "pid": 0, "tid": 7, "args": {"device": 0, "stream": 7}}]
    events += stopwatch.chrome_events([span], 0, 1)
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": 0}, f)
    device, _, window = trace.read(path)
    assert [e.name for e in device] == ["king_counts_wgmma_kernel"]
    assert window == (5.0, 905.0)
    stats = trace.analyze(path)
    assert stats["ops_busy_ms"] == stats["busy_union_ms"] == pytest.approx(0.3)
    assert events[1]["args"] == {"id": 2, "parent": 1, "root": 1, "entries": 10}


@pytest.fixture(scope="module")
def traced_sweep():
    """The spans of a traced engine sweep that waits on its count copies."""
    engine = engine_of(160)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(king, "LIMIT_CHECK_STEPS", 4)
        mp.setattr(king, "LIMIT_CHECK_WINDOW", 1)
        engine.run()
        stopwatch.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            engine.run()
    spans = stopwatch.recorded()
    stopwatch.clear()
    return spans


@pytest.mark.parametrize("name", sorted(TABLE))
def test_each_span_is_recorded_with_its_counts(name, traced_task, traced_sweep):
    spans = named(traced_task[0], name) or named(traced_sweep, name)
    assert spans, name
    for s in spans:
        assert s.start_ns <= s.end_ns and set(s.counts) == TABLE[name], s
        assert all(isinstance(v, int) and v >= 0 for v in s.counts.values()), s
    positive = {"bytes", "entries", "steps", "rows", "sweeps"}
    assert all(s.counts[k] > 0 for s in spans for k in TABLE[name] & positive), name


def test_worker_spans_from_many_threads_lose_nothing():
    """More threads than cores open and close spans under one handed-in
    parent, with a short switch interval: every span is kept, each id once."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    threads, each = 4 * (os.cpu_count() or 1) + 1, 200
    stopwatch.clear()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with stopwatch.span("cli.task") as root:
                def work(k):
                    for _ in range(each):
                        with stopwatch.span("ingest.decode", root) as s:
                            s.count(entries=k)

                with ThreadPoolExecutor(max_workers=threads) as pool:
                    for f in [pool.submit(work, k) for k in range(threads)]:
                        f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    spans = named(stopwatch.recorded(), "ingest.decode")
    stopwatch.clear()
    assert len(spans) == threads * each
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.parent == root.span.id and s.root == root.span.id for s in spans)
    assert sum(s.counts["entries"] for s in spans) == each * threads * (threads - 1) // 2
