"""Runs with the timed path broken underneath come out not correct.

Each test drives a whole tiny run on the CPU (the harness's look for a
card is the only part skipped) with one fault planted in the port: half of
the sweep's steps left out; a step that leaves its hit buffer unchanged;
an answer altered where it is produced (a kin bit in the engine's rows, a
row in the task's partition); half of a task's input left unread.  The
exchange between chips has no fault to plant: every cell of today's
``BENCHMARK.json`` runs on one card."""

import numpy as np
import pyarrow.parquet  # noqa: F401  (imported here first: see generate.write_input)
import pytest

from kingbench.tests.tiny import run_tiny


def _assert_caught(result):
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values()) or result["failed"]


def test_half_the_steps_left_out(monkeypatch):
    from cuking_tpu_torch.models.king import KingEngine

    params = KingEngine._panel_pair_params
    monkeypatch.setattr(KingEngine, "_panel_pair_params", lambda self: params(self)[::2])
    _assert_caught(run_tiny("sweep", split=1, shard=0))


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from cuking_tpu_torch.models import king

    emit = king.emit_hits
    calls = []

    def emit_but_the_third(*args, **kw):
        calls.append(1)
        if len(calls) % 7 != 3:
            emit(*args, **kw)

    monkeypatch.setattr(king, "emit_hits", emit_but_the_third)
    _assert_caught(run_tiny("sweep", split=1, shard=0))


@pytest.mark.parametrize("mode", ["sweep", "task"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, mode):
    from cuking_tpu_torch.models.king import ResultSet

    from_rows = ResultSet.from_rows.__func__

    def altered(cls, rows):
        rows = rows.copy()
        rows[2, 0] ^= 1  # the last bit of the first hit's kin
        return from_rows(cls, rows)

    monkeypatch.setattr(ResultSet, "from_rows", classmethod(altered))
    _assert_caught(run_tiny(mode))


def test_a_row_altered_at_the_writer(monkeypatch):
    from cuking_tpu_torch import cli

    write = cli.write_results

    def altered(storage, uri, results, samples, shard):
        results.ibs1 = np.asarray(results.ibs1).copy()
        results.ibs1[-1] += 1
        return write(storage, uri, results, samples, shard)

    monkeypatch.setattr(cli, "write_results", altered)
    _assert_caught(run_tiny("task"))


def test_half_the_input_left_unread(monkeypatch):
    from cuking_tpu_torch import cli

    ingest = cli.ingest_parquet
    monkeypatch.setattr(cli, "ingest_parquet",
                        lambda storage, files, *a, **kw: ingest(storage, files[::2], *a, **kw))
    _assert_caught(run_tiny("task"))
