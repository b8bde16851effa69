"""The readers of the port's spans (``kingbench/spans.py`` and the six
metrics that use it) on the CPU: each reads a real traced tiny run and
None without spans or without a recorder; the two sweep readers subtract
what they say; and the stage parser reads the CLI's six stages from its
output with and without a profiler."""

import contextlib
import io
import math

import pytest
from torch.profiler import ProfilerActivity, profile

from cuking_tpu_torch import cli
from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models import king
from cuking_tpu_torch.models.king import KingConfig, KingEngine
from cuking_tpu_torch.utils import stopwatch
from cuking_tpu_torch.utils.synthetic import random_genotypes

from kingbench import run
from kingbench.frozen.cli_at_scale import stage_seconds

STAGES = {"metadata", "allocate", "listing", "ingest", "king_kernel", "write"}
READERS = {  # metric → the traced run whose spans it reads
    "ingest_read_thread_s.task": "task", "ingest_decode_thread_s.task": "task",
    "ingest_filter_thread_s.task": "task", "ingest_scatter_thread_s.task": "task",
    "step_enqueue_us.sweep": "sweep", "sweep_edges_ms.sweep": "sweep",
}


def task_output(tmp, traced: bool) -> str:
    """One tiny CLI task's stdout; under a CPU profiler when ``traced``."""
    path = str(tmp / "input")
    g = random_genotypes(300, 200, missing_rate=0.05, seed=7, num_related_pairs=3)
    write_synthetic_input(Storage(), path, g, num_partitions=3)
    out = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        with contextlib.redirect_stdout(out):
            assert cli.main(["--input_uri", path, "--output_uri", str(tmp / "out"),
                             "--device", "cpu", "--kin_threshold", "0.05",
                             "--split_factor", "2", "--shard_index", "0",
                             "--panel", "64"]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def filled(tmp_path_factory):
    """The spans of a traced tiny CLI task and of a traced engine sweep with
    waits on its count copies."""
    stopwatch.clear()
    task_output(tmp_path_factory.mktemp("filled"), True)
    task = stopwatch.recorded()
    g = random_genotypes(160, 64, missing_rate=0.05, seed=3, num_related_pairs=2)
    engine = KingEngine.from_genotypes(g, KingConfig(panel=16, device="cpu",
                                                     kin_threshold=-1.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(king, "LIMIT_CHECK_STEPS", 4)
        mp.setattr(king, "LIMIT_CHECK_WINDOW", 1)
        engine.run()
        stopwatch.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            engine.run()
    sweep = stopwatch.recorded()
    stopwatch.clear()
    assert any(s.name == "engine.limit_wait" for s in sweep)
    return {"task": task, "sweep": sweep}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_span_reader_reads_a_real_run_and_none_without_spans(metric, filled,
                                                                  monkeypatch):
    read = run.reader(metric)
    monkeypatch.setattr(stopwatch, "_spans", list(filled[READERS[metric]]))
    value = read({"units": 1})
    assert value is not None and math.isfinite(value) and value > 0, value
    monkeypatch.setattr(stopwatch, "_spans", [])
    assert read({"units": 1}) is None


def test_readers_read_nothing_from_a_program_without_a_recorder(monkeypatch):
    monkeypatch.delattr(stopwatch, "recorded")
    for metric in READERS:
        assert run.reader(metric)({"units": 1}) is None, metric


def test_sweep_edges_and_enqueue_readers_subtract_what_they_say(monkeypatch):
    spans = [stopwatch.Span("engine.run", 1, None, 1, 5, 0, 10_000_000, {"sweeps": 1}),
             stopwatch.Span("engine.steps", 2, 1, 1, 5, 1_000_000, 8_000_000, {"steps": 4}),
             stopwatch.Span("engine.limit_wait", 3, 2, 1, 5, 2_000_000, 3_000_000),
             stopwatch.Span("engine.count_read", 4, 1, 1, 5, 8_000_000, 9_000_000)]
    monkeypatch.setattr(stopwatch, "_spans", spans)
    assert run.reader("sweep_edges_ms.sweep")({"units": 1}) == pytest.approx(2.0)
    assert run.reader("step_enqueue_us.sweep")({"units": 1}) == pytest.approx(1500)


@pytest.mark.parametrize("traced", [False, True])
def test_the_stage_parser_reads_the_six_stages_traced_or_not(tmp_path, traced):
    stopwatch.clear()
    assert set(stage_seconds(task_output(tmp_path, traced))) == STAGES
    stopwatch.clear()
