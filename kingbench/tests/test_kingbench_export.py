"""The export mode (``modes/export.py``) on the CPU: a whole tiny run of the
cell ``kgp30x.export``'s traffic comes out correct, traced and untraced,
with the span readers' metrics and the task stages' on the traced line; a port that drops one
row, or writes the threshold path's rows in the keep-all path's place,
comes out not correct; a port without ``--keep_all`` stops before any
input is drawn; the keep-all reference holds every pair, NaN and -inf kin
included, and agrees with the thresholded one above a threshold; the
control, in bfloat16, comes out not correct; and the emit kernel's
roofline counts the shard, not the launches."""

import argparse

import numpy as np
import pyarrow.parquet  # noqa: F401  (imported here first: see generate.write_input)
import pytest
import torch

from kingbench import check, control, run, tracing
from kingbench.emit_roofline import emit_bytes
from kingbench.modes import export
from kingbench.reference.every_pair import shard_rows_all
from kingbench.reference.king import shard_rows
from kingbench.roofline import PEAK_BYTES
from kingbench.tests.tiny import MANIFEST, SEED

NAME = "kgp30x.export"
SPANS = {"result_sort_s.export", "result_fetch_gbps.export", "writer_rows_per_s.export"}
# The task stages' readers that need no card (the idle share needs device events).
STAGES = {"ingest_entries_per_s.task", "ingest_read_thread_s.task",
          "ingest_decode_thread_s.task", "ingest_filter_thread_s.task",
          "ingest_scatter_thread_s.task", "allocate_s.task", "king_stage_s.task"}


def spec(samples: int = 300, sites: int = 500):
    """(cell, configuration, traffic) of a tiny export cell."""
    cell = next(w for w in MANIFEST["workloads"] if w["name"] == NAME)
    config = run.load_json(run.REPO, "kingbench/configs/kgp_30x_all_pairs.json")
    config.update(samples=samples, sites=sites, panel=128)
    traffic = run.load_json(run.HERE, "workloads", NAME + ".json")
    traffic.update(written_sites=sites, sites_per_file=120,
                   families=[{"size": 3, "degree": 1, "count": 20}])
    return cell, config, traffic


def run_tiny(trace: bool = False, seconds: float = 0.2) -> dict:
    return run.run_cell(MANIFEST, NAME, SEED, seconds, trace, device="cpu", spec=spec())


def _assert_caught(result):
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values()) or result["failed"]


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_export_run_is_correct(trace):
    r = run_tiny(trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["checks"].values())
    if trace:
        assert SPANS | STAGES <= set(r["metrics"])  # the emit roofline needs a card
        assert all(r["metrics"][m]["value"] > 0 for m in SPANS)
        # A tiny task's allocation reads 0.000 s in the CLI's log.
        assert all(r["metrics"][m]["value"] >= 0 for m in STAGES)
    else:
        assert set(r["metrics"]) == {"setup_s", "task_s", "peak_device_gib"}


def test_one_row_dropped_is_caught(monkeypatch):
    from cuking_tpu_torch.models.king import ResultSet

    from_rows = ResultSet.from_rows.__func__
    monkeypatch.setattr(ResultSet, "from_rows",
                        classmethod(lambda cls, rows: from_rows(cls, rows[:, 1:])))
    r = run_tiny()
    _assert_caught(r)
    assert r["checks"]["missing_rows"]["value"] == r["attempted"]


def test_the_threshold_paths_rows_in_place_of_every_pair_are_caught(monkeypatch):
    from cuking_tpu_torch import cli

    config = cli.KingConfig
    monkeypatch.setattr(cli, "KingConfig", lambda **kw: config(**{**kw, "keep_all": False}))
    r = run_tiny()
    _assert_caught(r)
    assert r["checks"]["missing_rows"]["value"] > 0


def test_a_port_without_keep_all_stops_before_drawing(monkeypatch):
    from cuking_tpu_torch import cli

    drawn = []
    monkeypatch.setattr(cli, "build_parser", argparse.ArgumentParser)
    monkeypatch.setattr(export.task, "draw", lambda *a: drawn.append(a))
    with pytest.raises(RuntimeError, match="--keep_all"):
        export.Session(*spec()[1:], SEED, "cpu")
    assert drawn == []


def test_the_reference_holds_every_pair_and_agrees_above_a_threshold():
    g = torch.randint(0, 3, (90, 300), generator=torch.Generator().manual_seed(4),
                      dtype=torch.int8)
    g[5] = 0   # no het: -inf with every other sample,
    g[9] = 0   # and NaN with sample 5 (0 / 0)

    def get_rows(ids, lo, hi):
        return g[torch.as_tensor(ids), lo:hi]

    for i_ids, j_ids, pairs in [(np.arange(90), None, 90 * 89 // 2),
                                (np.arange(40), np.arange(40, 90), 40 * 50)]:
        rows = shard_rows_all(get_rows, i_ids, j_ids, 300)
        assert len(rows) == pairs
        assert np.all(np.diff(rows[:, 0] * 90 + rows[:, 1]) > 0)
        kin = rows[:, 2].astype(np.uint32).view(np.float32)
        if j_ids is None:
            assert np.isnan(kin[(rows[:, 0] == 5) & (rows[:, 1] == 9)]).all()
            assert np.isneginf(kin[(rows[:, 0] == 5) & (rows[:, 1] != 9)]).all()
        above = rows[np.isfinite(kin) & (kin > np.float32(-0.3))]
        assert np.array_equal(above, shard_rows(get_rows, i_ids, j_ids, 300, -0.3))


def test_the_control_in_bfloat16_is_not_correct():
    _, config, traffic = spec(samples=200, sites=400)
    r = control.readings(config, traffic, SEED, "cpu")
    assert r["rows"] == r["control_rows"] == 200 * 199 // 2
    assert not r["correct"] and r["differing_rows"] > 0
    assert check.LIMITS["differing_rows"] == 0


def test_the_emit_roofline_counts_the_shard_not_the_launches():
    reader = run.reader("emit_kernel_roofline.export")
    pairs = 3202 * 3201 // 2
    # Three tasks of 10 launches, 0.3 ms of emit kernel in all.
    events = [{"name": "king_emit_kernel", "cat": "kernel", "ts": 100.0 * k, "dur": 10.0,
               "args": {"device": 0, "stream": 7}} for k in range(30)]
    events.append({"name": "kingbench.unit", "cat": "user_annotation", "ts": 0, "dur": 4e3})
    stats, _, _ = tracing.read_window({"traceEvents": [dict(ph="X", **e) for e in events],
                                       "deviceProperties": [{"id": 0, "name": "card"}]})
    ctx = {"trace": stats, "units": 3, "work": {"unique_pairs": pairs}}
    assert emit_bytes(pairs) == 48 * 5_124_801 == 245_990_448
    assert reader(ctx) == pytest.approx(100 * 3 * 245_990_448 / PEAK_BYTES / 0.3e-3)
    assert reader({**ctx, "units": 0}) is None
