"""The harness's pieces on the CPU: the import check, the layout against
the port's, the packer against the port's, the roofline count and the gap
labels on a canned trace, the stage parser on a captured CLI log, and a
whole tiny run of each mode, traced and untraced."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pyarrow.parquet  # noqa: F401  (imported here first: see generate.write_input)
import pytest
import torch

from kingbench import generate, run, tracing
from kingbench.frozen.cli_at_scale import stage_seconds
from kingbench.layout import Shard
from kingbench.modes.task import StampedStream, stage_spans
from kingbench.roofline import PEAK_INT8_OPS, count_work
from kingbench.tests.tiny import run_tiny

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "golden")


def test_forbidden_modules_compare_whole_top_level_names():
    allowed = ["cuking_tpu_torch", "cuking_tpu_torch.cli", "jaxtyping", "flaxen.x", "numpy"]
    assert run.forbidden_modules(allowed) == []
    banned = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "cuking_tpu",
              "cuking_tpu.cli"]
    assert run.forbidden_modules(allowed + banned) == sorted(banned)


@pytest.mark.parametrize("samples,split,shard,panel", [
    (40960, 5, 4, 1024), (65536, 1, 0, 1024), (730947, 5, 4, 1024), (3001, 5, 14, 128),
    (301, 3, 1, 64), (301, 3, 0, 64)])
def test_layout_matches_the_port(samples, split, shard, panel):
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    lay = Shard(samples, split, shard, panel)
    sm = Submatrix.create(samples, split, shard)
    assert (lay.i_range, lay.j_range) == ((sm.i_begin, sm.i_end), (sm.j_begin, sm.j_end))
    ids = lay.sample_ids()
    assert np.array_equal(ids, sm.stored_sample_indices())
    nr = -(-sm.num_rows // panel) * panel
    total = nr if sm.is_diagonal else nr + -(-sm.num_cols // panel) * panel
    assert lay.stored_rows == total
    in_j = (ids >= sm.i_end) & ~sm.is_diagonal
    assert np.array_equal(lay.storage_rows(),
                          np.where(in_j, nr + ids - sm.j_begin, ids - sm.i_begin))


def test_layout_storage_rows_match_panel_storage():
    from cuking_tpu_torch.models.king import PanelStorage
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    lay = Shard(301, 3, 1, 64)
    st = PanelStorage(PlaneLayout.create(100), Submatrix.create(301, 3, 1), 64)
    assert st.planes.shape[1] == lay.stored_rows
    assert np.array_equal(st.storage_offsets(lay.sample_ids()), lay.storage_rows())


@pytest.mark.parametrize("sites", [100, 2000, 93511])
def test_pack_matches_the_port(sites):
    from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes

    traffic = {"allele_freq": [0.1, 0.5], "missing_rate": 0.05}
    codes = generate.draw_codes(5, 9, sites, traffic, "cpu")
    layout = PlaneLayout.create(sites)
    want = pack_genotypes(codes.numpy(), layout)
    got = generate.pack(codes, layout.words).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_draw_is_the_seeds_and_hardy_weinberg():
    traffic = {"allele_freq": [0.1, 0.5], "missing_rate": 0.05}
    a = generate.draw_codes(2**33 + 1, 600, 300, traffic, "cpu")
    assert torch.equal(a, generate.draw_codes(2**33 + 1, 600, 300, traffic, "cpu"))
    assert not torch.equal(a, generate.draw_codes(2**33 + 2, 600, 300, traffic, "cpu"))
    share = [(a == v).double().mean().item() for v in (-1, 0, 1, 2)]
    assert abs(share[0] - 0.05) < 0.01 and share[2] > 0.3


def test_families_plant_clones_at_the_shard_corners():
    name = "gnomad_v4.sweep"
    traffic = run.load_json(run.HERE, "workloads", name + ".json")
    lay = Shard(40960, 5, 4, 1024)
    fams = generate.families(traffic, lay, 7)
    assert fams[0][0].tolist() == [0, 40959] and fams[0][1] == 0
    rows = np.concatenate([r for r, _ in fams])
    ids = lay.sample_ids()
    assert len(np.unique(rows)) == len(rows) and np.isin(rows, ids).all()


def _trace(events):
    return {"traceEvents": [dict(ph="X", **e) for e in events],
            "deviceProperties": [{"id": 0, "name": "card"}]}


def test_roofline_counts_the_shard_not_the_launches():
    reader = run.reader("count_kernel_roofline.sweep")
    # Two sweeps of 8,192 x 8,192 pairs at 1M sites; 0.678 s of count kernel.
    events = [{"name": "king_counts_wgmma_kernel", "cat": "kernel", "ts": 1000.0 * k,
               "dur": 5296.875, "args": {"device": 0, "stream": 7}} for k in range(128)]
    events.append({"name": "kingbench.unit", "cat": "user_annotation", "ts": 0, "dur": 2e5})
    stats, _, _ = tracing.read_window(_trace(events))
    ctx = {"trace": stats, "units": 2,
           "work": {"unique_pairs": 8192 * 8192, "samples": 16384, "sites": 1_000_000}}
    ops, nbytes = count_work(8192 * 8192, 16384, 1_000_000)
    assert (ops, nbytes) == (671088640000000, 4096000000)
    assert reader(ctx) == pytest.approx(100 * 2 * ops / PEAK_INT8_OPS / 0.678)
    assert run.reader("emit_kernel_us_per_step.sweep")(ctx) is None


def test_idle_gaps_are_labelled_by_the_host():
    events = [{"name": "king_counts_wgmma_kernel", "cat": "kernel", "ts": 100, "dur": 50,
               "args": {"device": 0, "stream": 7}},
              {"name": "king_emit_kernel", "cat": "kernel", "ts": 400, "dur": 10,
               "args": {"device": 0, "stream": 7}},
              {"name": "kingbench.unit", "cat": "user_annotation", "ts": 0, "dur": 300},
              {"name": "kingbench.unit", "cat": "user_annotation", "ts": 350, "dur": 150}]
    trace = _trace(events)
    stats, dev, window = tracing.read_window(trace)
    spans = tracing.host_spans(trace)
    gaps = tracing.idle_gaps(dev, window, lambda t: "inside" if any(
        s <= t <= e for s, e in spans) else "between")
    assert gaps == [["inside", 250e-6], ["inside", 100e-6], ["inside", 90e-6]]
    assert tracing.idle_share({"trace": stats, "chips": 1}) == pytest.approx(100 * (1 - 60 / 500))
    assert tracing.device_ops(dev)[0] == ["king_counts_wgmma_kernel", 50e-6]


def test_stage_parser_reads_a_captured_cli_log(tmp_path):
    from cuking_tpu_torch import cli

    log = StampedStream()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["--input_uri", os.path.join(GOLDEN, "input.parquet"), "--output_uri",
                       str(tmp_path / "out"), "--device", "cpu", "--kin_threshold", "0.05"])
    assert rc == 0
    stages = stage_seconds(log.getvalue())
    assert set(stages) == {"metadata", "allocate", "listing", "ingest", "king_kernel", "write"}
    spans = stage_spans(log)
    assert [s for _, _, s in spans] == ["metadata", "allocate", "listing", "ingest",
                                        "king_kernel", "write"]
    assert all(a <= b for a, b, _ in spans)


@pytest.mark.parametrize("mode", ["sweep", "task"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(mode, trace):
    r = run_tiny(mode, trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r["checks"]) == ["missing_rows", "extra_rows", "differing_rows",
                                 "unsorted_rows"]
    if trace:
        assert r["device"]["window_s"] > 0 and "breakdown" in r
        if mode == "task":  # stage metrics need no device
            assert {"ingest_entries_per_s.task", "allocate_s.task",
                    "king_stage_s.task"} <= set(r["metrics"])
    else:
        e2e = {"sweep": "sweep_pairs_per_s", "task": "task_s"}[mode]
        assert set(r["metrics"]) == {"setup_s", e2e, "peak_device_gib"}


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
                           "gnomad_v4.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
