"""The port's trace reader (``cuking_tpu_torch/utils/trace.py``) and its twin
of ``tools/trace_report.py`` (``tools/torch_trace_report.py``) on the CPU:
the categories of real event names; exact readings of a hand-written
two-card Chrome trace; a CLI ``--profile_dir`` trace of a CPU run read
without error; the tool's CPU run, and its refusal without a card; and the
tool's hitful and ring rows against the JAX ``KingEngine`` on the JAX
tool's own CPU inputs, bit for bit."""

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from cuking_tpu.models.king import KingConfig as JaxConfig
from cuking_tpu.models.king import KingEngine as JaxEngine
from cuking_tpu.models.king import PanelStorage as JaxPanelStorage
from cuking_tpu.ops.bitset import PlaneLayout as JaxPlaneLayout
from cuking_tpu.parallel.submatrix import Submatrix as JaxSubmatrix

from cuking_tpu_torch import cli
from cuking_tpu_torch.utils import bounds, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_trace_report.py")
GOLDEN_INPUT = os.path.join(REPO, "tests", "golden", "input.parquet")
tool = importlib.import_module("tools.torch_trace_report")

# Device event names as export_chrome_trace writes them.  The first nine are
# from traces taken on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128): six by
# tools/torch_trace_report.py, then a host-to-device upload, a device copy
# and the first port's AND + popcount count kernel, since retired (any
# ``king_counts`` kernel is still filed as a count kernel); the others are
# the profiler's names for activities those traces do not have (peer copies
# and NCCL need two cards).
NAMES = [
    ("(anonymous namespace)::king_counts_wgmma_kernel(unsigned int const*, long long, "
     "long long, long long, unsigned int const*, long long, long long, long long, "
     "long long, int, int*)", "kernel", trace.COUNT_KERNEL),
    ("(anonymous namespace)::king_emit_kernel(int const*, long long, long long, long long, "
     "long long, long long, long long, float, int, int, int*, long long, unsigned long "
     "long*)", "kernel", trace.EMIT_KERNEL),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::FillFunctor<long>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<long>, std::array<char*, 1ul>)",
     "kernel", trace.OTHER_KERNELS),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>", "kernel",
     trace.OTHER_KERNELS),
    ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", "memcpy DtoH"),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", "memcpy DtoH"),
    ("(anonymous namespace)::king_counts_popc_kernel(unsigned int const*, long long, "
     "long long, long long, unsigned int const*, long long, long long, long long, "
     "long long, int, int*)", "kernel", trace.COUNT_KERNEL),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "memcpy HtoD"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "memcpy DtoD"),
    ("Memcpy PtoP (Device -> Device)", "gpu_memcpy", trace.PEER),
    ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)", "kernel", trace.PEER),
    ("Memset (Device)", "gpu_memset", trace.MEMSET),
    ("aten::copy_", "cpu_op", None),
    ("cudaLaunchKernel", "cuda_runtime", None),
    ("king_counts_wgmma_kernel", "cuda_runtime", None),
    ("ProfilerStep#1", "gpu_user_annotation", None),
]


@pytest.mark.parametrize("name,cat,expected", NAMES, ids=[f"{c}:{n[:40]}" for n, c, _ in NAMES])
def test_classify(name, cat, expected):
    assert trace.classify(name, cat) == expected


KERNEL_SOURCE = os.path.join(REPO, "cuking_tpu_torch", "csrc", "king_counts.cu")
FROZEN_TRACE = os.path.join(REPO, "kingbench", "frozen", "trace.py")


def test_every_kernel_of_the_count_step_is_count_kernel_time():
    """Every ``__global__`` kernel in ``csrc/king_counts.cu`` has
    ``king_counts`` in its name, the main path's ``king_counts_wgmma_kernel``
    among them, and the port's classify and the benchmark's frozen copy
    (read from its file; it is stdlib only) both put each in the count
    kernel's category, so that no count-step work escapes the roofline."""
    with open(KERNEL_SOURCE) as f:
        source = f.read()
    names = re.findall(  # past attributes such as __cluster_dims__ and __launch_bounds__
        r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s+)*(\w+)\s*\(", source)
    assert trace.LAUNCH_NAMES["king_counts"] == "king_counts_wgmma_kernel"
    assert "king_counts_wgmma_kernel" in names
    spec = importlib.util.spec_from_file_location("frozen_trace", FROZEN_TRACE)
    frozen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(frozen)
    for name in names:
        assert "king_counts" in name, name
        shown = f"(anonymous namespace)::{name}(CUtensorMap_st, long long, int*)"
        assert trace.classify(shown, "kernel") == trace.COUNT_KERNEL, name
        assert frozen.classify(shown, "kernel") == frozen.COUNT_KERNEL, name


def _x(name, cat, ts, dur, card=0, stream=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": card, "tid": stream, "ts": ts,
            "dur": dur, "args": {"device": card, "stream": stream}}


COUNT = "(anonymous namespace)::king_counts_wgmma_kernel(unsigned int const*)"
EMIT = "(anonymous namespace)::king_emit_kernel(int const*)"
T0 = 1_000_000.0  # a trace's timestamps are the host clock's, in us


@pytest.fixture()
def two_cards(tmp_path):
    """Card 0: a count kernel over 0-100 us with a peer copy on a side
    stream under it (40-70), the emit kernel, a memset, a fill kernel and a
    copy to the host on the compute stream.  Card 1: a count kernel over
    200-300, a peer copy at 20-60 (under card 0's kernel, not its own) and
    an NCCL kernel at 250-270 under its own.  An annotation on card 0's
    timeline spans it all; host events open and close the window."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 9, "tid": 9,
         "ts": T0 - 50, "dur": 10},
        _x(COUNT, "kernel", T0, 100),
        _x(EMIT, "kernel", T0 + 100, 10),
        _x("Memcpy PtoP (Device -> Device)", "gpu_memcpy", T0 + 40, 30, stream=20),
        _x("Memset (Device)", "gpu_memset", T0 + 120, 5),
        _x("void at::native::vectorized_elementwise_kernel<2>", "kernel", T0 + 130, 10),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", T0 + 140, 10),
        _x("ProfilerStep#1", "gpu_user_annotation", T0, 300),
        _x(COUNT, "kernel", T0 + 200, 100, card=1),
        _x("Memcpy PtoP (Device -> Device)", "gpu_memcpy", T0 + 20, 40, card=1, stream=21),
        _x("ncclDevKernel_SendRecv(ncclDevComm*)", "kernel", T0 + 250, 20, card=1, stream=22),
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 9, "tid": 9,
         "ts": T0 + 400, "dur": 20},
        {"ph": "i", "cat": "cpu_instant_event", "name": "mark", "pid": 9, "tid": 9,
         "ts": T0 + 900},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({
        "deviceProperties": [{"id": 0, "name": "card zero"}, {"id": 1, "name": "card one"}],
        "traceEvents": events}))
    return str(path)


def test_analyze_reads_exact_times(two_cards):
    """Category sums, the per-card union against the sum, both spans, the
    copies off the count kernel's stream and the launches, exactly."""
    s = trace.analyze(two_cards)
    assert s["by_category_ms"] == pytest.approx({
        trace.COUNT_KERNEL: 0.2, trace.PEER: 0.09, trace.EMIT_KERNEL: 0.01,
        trace.OTHER_KERNELS: 0.01, "memcpy DtoH": 0.01, trace.MEMSET: 0.005})
    assert list(s["by_category_ms"])[:2] == [trace.COUNT_KERNEL, trace.PEER]
    assert s["events_by_category"][trace.COUNT_KERNEL] == 2
    assert s["events_by_category"][trace.PEER] == 3
    assert s["ops_busy_ms"] == pytest.approx(0.325)
    # Card 0: [0, 110] + [120, 125] + [130, 150]; card 1: [20, 60] + [200, 300].
    assert s["busy_union_ms"] == pytest.approx(0.135 + 0.140)
    assert s["busy_union_ms"] < s["ops_busy_ms"]
    assert s["span_ms"] == pytest.approx(0.3)
    assert s["trace_span_ms"] == pytest.approx(0.47)
    assert s["async_copy_ms"] == pytest.approx(0.07)  # the two peer copies' side streams
    assert s["launches"] == {"king_counts": 2, "king_emit": 1}
    assert s["device_events"] == 9
    assert s["cards"] == {"0": "card zero", "1": "card one"}


def test_a_card_never_covers_another_cards_transfer(two_cards):
    """Card 1's peer copy lies under card 0's count kernel in time, and is
    not covered; card 0's copy and card 1's NCCL kernel lie under their own
    cards' kernels, and are."""
    per_card = trace.intervals_per_card(two_cards)
    assert per_card[1][trace.PEER] == [(T0 + 20, T0 + 60), (T0 + 250, T0 + 270)]
    assert per_card[0][trace.COUNT_KERNEL] == [(T0, T0 + 100)]
    assert trace.COUNT_KERNEL in per_card[1] and trace.EMIT_KERNEL not in per_card[1]
    overlap = trace.analyze(two_cards)["transfer_overlap"]
    assert overlap["num_transfers"] == 3
    assert overlap["transfer_ms"] == pytest.approx(0.09)
    assert overlap["covered_ms"] == pytest.approx(0.05)
    assert overlap["overlap_fraction"] == pytest.approx(5 / 9)
    pooled = trace.covered_share([
        (0, "transfer" if cat == trace.PEER else "kernel", s, e) for per in per_card.values()
        for cat in (trace.PEER, trace.COUNT_KERNEL) for s, e in per[cat]])
    assert pooled["covered_ms"] == pytest.approx(0.09)  # pooling the cards would
    assert trace.covered_share([(0, "kernel", 0.0, 1.0)]) is None


def test_report_names_the_card_and_every_category(two_cards):
    text = trace.report("two cards", trace.analyze(two_cards), "NVIDIA H100 80GB HBM3, 700.00 W")
    assert text.splitlines()[0] == "== two cards (NVIDIA H100 80GB HBM3, 700.00 W) =="
    for cat in (trace.COUNT_KERNEL, trace.PEER, trace.MEMSET, "memcpy DtoH"):
        assert cat in text
    assert "card zero, card one" in trace.report("x", trace.analyze(two_cards))


def test_analyze_reads_a_cli_profile_dir_trace_of_a_cpu_run(tmp_path):
    """The CLI's --profile_dir on the CPU writes a trace with host events
    only: it reads as no device time, without an error."""
    rc = cli.main(["--input_uri", GOLDEN_INPUT, "--output_uri", str(tmp_path / "out.parquet"),
                   "--kin_threshold", "0.0884", "--device", "cpu", "--quiet",
                   "--profile_dir", str(tmp_path / "prof")])
    assert rc == 0
    s = trace.analyze(str(tmp_path / "prof" / "trace-part-00000.json"))
    assert s["device_events"] == 0 and s["by_category_ms"] == {} and s["cards"] == {}
    assert s["busy_union_ms"] == s["span_ms"] == s["ops_busy_ms"] == 0.0
    assert s["launches"] == {"king_counts": 0, "king_emit": 0}
    assert s["transfer_overlap"] is None and s["trace_span_ms"] > 0
    assert "device time not measured" in trace.report("cli", s)


def test_tool_cpu_run(tmp_path):
    """--device cpu: exit 0, the three traces written, the tables, and one
    JSON line last with the three readings, the hits and no card."""
    proc = subprocess.run([sys.executable, TOOL, "--device", "cpu", "--outdir", str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for run in tool.RUNS:
        assert (tmp_path / run / "trace.json").is_file()
    lines = proc.stdout.strip().splitlines()
    assert sum(line.startswith("== ") for line in lines) == 3
    line = json.loads(lines[-1])
    assert list(line["runs"]) == list(tool.RUNS)
    assert [line["runs"][r]["hits"] for r in tool.RUNS] == [0, 48, 48]
    assert line["planted_pairs"] == 48 and line["checks_failed"] == []
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    for run in line["runs"].values():
        assert run["analysis"]["device_events"] == 0
        assert run["launches_counted"] == {"king_counts": 0, "king_emit": 0}


def test_tool_refuses_without_a_card():
    """The default device is the card: with none, exit 2, one error line on
    stderr and nothing on stdout."""
    proc = subprocess.run([sys.executable, TOOL], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2
    assert proc.stdout == ""
    err = proc.stderr.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]


@pytest.mark.parametrize("run", ["engine_hitful", "ring_1dev"])
def test_hitful_rows_match_the_jax_engine_on_the_jax_tools_inputs(run):
    """The JAX tool's CPU inputs rebuilt as it builds them (192 x 2,000,
    default_rng(0) over the planes, 8 families of 4 cloned): the port
    tool's planes equal them, and its hitful sweep's and ring's rows at
    0.08841 equal the JAX KingEngine's (matmul), kin as uint32 bits."""
    s = tool.CPU
    layout = JaxPlaneLayout.create(s.sites, words_multiple=s.site_chunk_words)
    jax_storage = JaxPanelStorage(layout, JaxSubmatrix.create(s.samples, 1, 0), s.panel)
    rng = np.random.default_rng(0)
    jax_storage.planes[:] = rng.integers(0, 2**32, jax_storage.planes.shape, dtype=np.uint32)
    for fam in range(s.families):
        src = fam * s.members
        for m in range(1, s.members):
            jax_storage.planes[:, src + m, :] = jax_storage.planes[:, src, :]
    jax_storage.mark_mutated()
    ref = JaxEngine(jax_storage, JaxConfig(kin_threshold=0.08841, panel=s.panel,
                                           kernel="matmul", site_chunk_words=s.site_chunk_words,
                                           sweep_batch=16)).run()

    engine = tool.make_engine(s, 0, "cpu")
    planted = tool.plant_families(engine, s)
    assert np.array_equal(engine.storage.planes, jax_storage.planes)
    got = (tool.engine_rows if run == "engine_hitful" else tool.ring_rows)(engine, 0.08841)
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))
    assert len(got) == len(planted) == 48 and tool.planted_failures(got, planted) == []


def test_bounds_moved_unchanged():
    """chip_smoke.py re-exports the package's bounds, and they read as
    before: 0.530 ms for a 1024 x 1024 pair at 100,000 sites (3,128 words),
    5.008 us for a hit-free emit step."""
    import chip_smoke

    assert chip_smoke.count_bound is bounds.count_bound
    assert chip_smoke.emit_bound is bounds.emit_bound
    assert (bounds.PEAK_INT8_OPS, bounds.PEAK_BYTES, bounds.PEAK_FP32_OPS) == (
        1.979e15, 3.35e12, 67e12)
    ms, by = bounds.count_bound(1024, 1024, 3128)
    assert (round(ms, 4), by) == (0.5304, "operations")
    ms, by = bounds.emit_bound(1024 * 1024, 0)
    assert (round(1e3 * ms, 3), by) == (5.008, "bytes")
