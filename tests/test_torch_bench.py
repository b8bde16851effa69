"""bench_torch.py, the port's benchmark, on the CPU: it loads neither jax nor
cuking_tpu; without a card it reports no number and exits 2; ``--device
cpu`` prints one line with every key of bench.py's line; its hitful
workload gives the JAX engine's rows bit for bit; SIGTERM, a failed section
and a spent budget each give one line and the documented exit code."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from cuking_tpu.models.king import KingConfig as JaxConfig
from cuking_tpu.models.king import KingEngine as JaxEngine
from cuking_tpu.models.king import PanelStorage as JaxPanelStorage
from cuking_tpu.ops.bitset import PlaneLayout as JaxPlaneLayout
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix

import bench_torch
from cuking_tpu_torch.models.king import KingConfig, KingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
OPTIONAL = ["sweep_1m_sites", "hitful", "kernel_only", "ingest", "ring_path"]

# The keys of bench.py's line (its RESULT and what its sections write into
# diagnostics), but warmup_compile_s: the port times its one-time nvcc
# build apart from the first sweep (build_s, warmup_s).
BENCH_PY_KEYS = ["metric", "value", "unit", "vs_baseline", "backend", "diagnostics"]
BENCH_PY_DIAGNOSTICS = [
    "skipped", "sweep_runs_ms", "sweep_ms_min_median_max",
    "popcount_baseline_pairs_per_sec", "pairs_per_sec_1m_sites", "num_sites_1m",
    "num_samples_1m", "pairs_per_sec_hitful_default_threshold", "hitful_runs_ms",
    "hits_emitted", "kernel_only_pairs_per_sec", "ingest_entries_per_sec",
    "ingest_entries_per_sec_numpy", "ingest_entries_per_sec_native",
    "pairs_per_sec_ring_path_1dev",
]
PORT_DIAGNOSTICS = ["warmup_s", "build_s", "kernel_only_ms", "kernel_only_bound_ms",
                    "card", "torch", "cuda", "nvcc", "budget_s", "seed", "launches",
                    "words", "ring_hits"]


def run_bench(*args, env=None):
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", *args], cwd=REPO, capture_output=True,
        text=True, timeout=TIMEOUT_S, env={**os.environ, **(env or {})},
    )
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout + proc.stderr
    return proc.returncode, json.loads(lines[0]), proc.stderr


_IMPORTS = """
import json, sys
import bench_torch
at_import = sorted(k for k in sys.modules if k.split(".")[0] in
                   ("jax", "jaxlib", "cuking_tpu", "triton", "pyarrow", "hail"))
rc = bench_torch.main(["--device", "cpu"])
after_run = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "cuking_tpu"))
print(json.dumps([rc, at_import, after_run]), file=sys.stderr)
"""


def test_bench_loads_no_jax_and_no_cuking_tpu():
    """(a) Neither at import nor through a whole CPU run; triton and
    pyarrow are not loaded at import either."""
    proc = subprocess.run([sys.executable, "-c", _IMPORTS], cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    rc, at_import, after_run = json.loads(proc.stderr.splitlines()[-1])
    assert (rc, at_import, after_run) == (0, [], [])


def test_no_card_reports_no_number_and_exits_2():
    """(b) The default device is the card; with none visible the line says
    so, carries no number and the exit code is 2."""
    rc, line, _ = run_bench(env={"CUDA_VISIBLE_DEVICES": ""})
    assert rc == 2
    assert line["value"] == 0 and line["vs_baseline"] == 0.0
    assert line["backend"] == "none"
    assert "no CUDA card" in line["diagnostics"]["error"]
    assert "CPU FALLBACK" not in line["metric"]


def test_cpu_run_has_every_key_of_bench_py():
    """(c) One line with bench.py's keys and the port's, the metric labelled
    as a CPU check, every section run and both checks held."""
    rc, line, _ = run_bench("--device", "cpu")
    assert rc == 0
    assert list(line) == BENCH_PY_KEYS
    diag = line["diagnostics"]
    missing = [k for k in BENCH_PY_DIAGNOSTICS + PORT_DIAGNOSTICS if k not in diag]
    assert missing == []
    assert line["metric"] == ("sample-pairs/sec/chip @ 2000 sites (KING kinship+IBS) "
                              "[CPU FALLBACK — not a chip number]")
    assert line["unit"] == "pairs/s" and line["backend"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert diag["skipped"] == []
    assert diag["hits_emitted"] == diag["ring_hits"] == diag["hits_planted"] == 8 * 6
    assert list(diag["launches"]) == ["headline", "popcount_baseline"] + OPTIONAL
    assert diag["kernel_only_timer"].startswith("host clock")


def test_hitful_workload_matches_the_jax_engine():
    """(d) The bench's hitful planes at its CPU size, made by its own
    functions, through the JAX engine (matmul kernel) and the port's: the
    same rows, kin as uint32 bits; every planted pair present."""
    s = bench_torch.CPU
    storage = bench_torch.random_storage(s.samples, s.sites, s.panel,
                                         np.random.default_rng(0))
    planted = bench_torch.plant_families(storage.planes, s.families, s.members)
    assert len(planted) == s.families * s.members * (s.members - 1) // 2
    common = dict(kin_threshold=0.0884, panel=s.panel, kernel="matmul",
                  site_chunk_words=s.site_chunk_words)
    jax_storage = JaxPanelStorage(
        JaxPlaneLayout(num_sites=s.sites, words=storage.layout.words),
        JaxSubmatrix.create(s.samples, 1, 0), s.panel)
    jax_storage.planes[:] = storage.planes
    ref = JaxEngine(jax_storage, JaxConfig(**common)).run()
    got = KingEngine(storage, KingConfig(**common, device="cpu")).run()
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))
    assert bench_torch.check_hits(got, planted, storage.planes) == len(got) - len(planted)


def test_check_hits_fails_on_a_missing_or_wrong_pair():
    """The hitful check is not vacuous: at a keep-all threshold it holds
    every other hit to the plain version, and a dropped planted pair, a
    changed planted kin and a changed IBS count of another hit each fail
    it."""
    s = bench_torch.CPU
    storage = bench_torch.random_storage(s.samples, s.sites, s.panel,
                                         np.random.default_rng(1))
    planted = bench_torch.plant_families(storage.planes, s.families, s.members)
    rs = KingEngine(storage, KingConfig(panel=s.panel, kernel="matmul", device="cpu",
                                        kin_threshold=-2.0,
                                        site_chunk_words=s.site_chunk_words)).run()
    others = s.samples * (s.samples - 1) // 2 - len(planted)
    assert bench_torch.check_hits(rs, planted, storage.planes) == others
    with pytest.raises(RuntimeError, match="planted pairs missing"):
        bench_torch.check_hits(rs, np.vstack([planted, [[0, s.samples]]]), storage.planes)
    planted_set = {tuple(p) for p in planted}
    first_other = next(k for k, ij in enumerate(zip(rs.i_idx, rs.j_idx))
                       if ij not in planted_set)
    rs.ibs1[first_other] += 1
    with pytest.raises(RuntimeError, match="the plain version"):
        bench_torch.check_hits(rs, planted, storage.planes)
    rs.kin[0] = np.float32(0.25)  # (0, 1): a planted pair
    with pytest.raises(RuntimeError, match="kin != 0.5"):
        bench_torch.check_hits(rs, planted, storage.planes)


class _Exited(Exception):
    pass


def test_sigterm_prints_one_line_and_exits_nonzero(monkeypatch, capsys):
    """(e) The handler prints the line assembled so far, once, with
    terminated_early, and exits 143."""
    def fake_exit(code):
        raise _Exited(code)

    monkeypatch.setattr(bench_torch.os, "_exit", fake_exit)
    run = bench_torch.Run(budget_s=500.0, seed=0)
    run.result["value"] = 123
    with pytest.raises(_Exited) as exited:
        run.on_term(signal.SIGTERM, None)
    assert exited.value.args == (bench_torch.EXIT_TERMINATED,) and exited.value.args[0] != 0
    with pytest.raises(_Exited):
        run.on_term(signal.SIGTERM, None)  # a second signal prints nothing more
    run.emit()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["diagnostics"]["terminated_early"] is True and line["value"] == 123


def test_a_failed_section_is_named_and_exits_1(monkeypatch, capsys):
    """(f) A section that raises shows as <name>:failed, the others still
    run, and the run exits 1 after printing its line."""
    def broken(b):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(bench_torch, "sec_ingest", broken)
    handler = signal.getsignal(signal.SIGTERM)
    rc = bench_torch.main(["--device", "cpu"])
    assert signal.getsignal(signal.SIGTERM) == handler  # main restores it
    lines = capsys.readouterr().out.splitlines()
    assert rc == 1 and len(lines) == 1
    diag = json.loads(lines[0])["diagnostics"]
    assert diag["skipped"] == ["ingest:failed"]
    assert "pairs_per_sec_ring_path_1dev" in diag and "ingest_entries_per_sec" not in diag


def test_a_failed_required_section_exits_1(monkeypatch, capsys):
    """The headline and the popcount baseline are required: a failure there
    exits 1 with the error in the line and no vs_baseline."""
    def broken(b):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(bench_torch, "sec_popcount_baseline", broken)
    rc = bench_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 1 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["vs_baseline"] == 0.0
    assert line["diagnostics"]["error"] == "RuntimeError: broken on purpose"


def test_zero_budget_skips_every_optional_section():
    """(g) BENCH_BUDGET_S=0: the required sections run, every optional one is
    skipped and named, and the run exits 0."""
    rc, line, _ = run_bench("--device", "cpu", env={"BENCH_BUDGET_S": "0"})
    assert rc == 0
    assert line["diagnostics"]["skipped"] == OPTIONAL
    assert line["value"] > 0 and line["vs_baseline"] > 0
