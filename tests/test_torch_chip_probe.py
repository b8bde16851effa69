"""The card monitor (``cuking_tpu_torch/utils/card.py``) and the port's twin
of ``tools/chip_probe.py`` (``tools/torch_chip_probe.py``) on the CPU: the
sampler against canned ``nvidia-smi`` output and a fake ``nvidia-smi``
process; the differenced time on a fake clock; the operation counts and
shares against ``utils/bounds.py``; the three data kinds; the probe's
counters against the JAX package's Pallas kernel in interpret mode; the
tool's CPU run and its refusal without a card.

Only the parity test imports jax."""

import importlib
import json
import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cuking_tpu_torch.ops.bitset import PlaneLayout, planes_to_genotypes
from cuking_tpu_torch.utils import bounds, card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_chip_probe.py")
tool = importlib.import_module("tools.torch_chip_probe")

HELP_EVENT = ('"timestamp"\n"clocks.current.sm" or "clocks.sm"\n"clocks.current.memory" or '
              '"clocks.mem"\n"power.draw"\n"power.draw.instant" or "gpu.power.draw.instant"\n'
              '"temperature.gpu"\n"clocks_event_reasons.active" or '
              '"clocks_throttle_reasons.active"\n')
HELP_THROTTLE = ('"timestamp"\n"clocks.sm"\n"clocks.mem"\n"power.draw"\n"temperature.gpu"\n'
                 '"clocks_throttle_reasons.active"\n')
HELP_NEITHER = '"timestamp"\n"clocks.sm"\n"clocks.mem"\n"power.draw"\n"temperature.gpu"\n'


def stamp(t: float) -> str:
    """``t`` (time.time() seconds) as nvidia-smi prints a timestamp."""
    return time.strftime("%Y/%m/%d %H:%M:%S", time.localtime(t)) + f".{int(t * 1e3) % 1000:03d}"


@pytest.mark.parametrize("help_text,reasons,instant", [
    (HELP_EVENT, "clocks_event_reasons.active", True),
    (HELP_THROTTLE, "clocks_throttle_reasons.active", False),
    (HELP_NEITHER, None, False),
])
def test_fields_follow_what_nvidia_smi_lists(help_text, reasons, instant):
    fields, about = card.choose_fields(card.listed_fields(help_text))
    assert list(fields)[:5] == list(card.BASE_FIELDS)
    assert about["reasons"] == reasons and (reasons in fields) == (reasons is not None)
    assert ("power.draw.instant" in fields) == instant
    assert about["power_instant_w"] == ("power.draw.instant" if instant else None)
    if reasons is None:
        assert "reasons_note" in about and "reasons" not in fields.values()
    if not instant:
        assert "does not list" in about["power_instant_w_note"]


def test_canned_lines_parse_unreadable_fields_to_none():
    fields, _ = card.choose_fields(card.listed_fields(HELP_EVENT))
    t = 1_790_000_000.25
    assert list(fields.values()) == ["t", "sm_mhz", "mem_mhz", "power_w", "temperature_c",
                                     "power_instant_w", "reasons"]
    text = (f"{stamp(t)}, 1980, 2619, 130.62, 39, [N/A], 0x0000000000000000\n"
            f"{stamp(t + 0.05)}, 1620, 2619, 698.61, 58, 707.87, 0x0000000000000004\n"
            f"{stamp(t + 0.1)}, [Not Supported], [N/A], [N/A], [N/A], [N/A], [N/A]\n"
            f"{stamp(t + 0.15)}, 1395, 26")  # still being written: left out
    s = card.parse_lines(text, fields)
    assert len(s) == 3
    assert s[0]["t"] == pytest.approx(t, abs=1e-3) and s[1]["t"] - s[0]["t"] == pytest.approx(0.05)
    assert (s[0]["sm_mhz"], s[0]["power_w"], s[0]["power_instant_w"], s[0]["reasons"]) == (
        1980.0, 130.62, None, 0)
    assert (s[1]["power_instant_w"], s[1]["reasons"]) == (707.87, 4)
    assert all(s[2][k] is None for k in s[2] if k != "t")
    rec = card.summarize(s)
    assert rec["samples"] == 3 and rec["sm_samples"] == 2
    assert (rec["sm_mhz_median"], rec["sm_mhz_min"], rec["power_w_max"]) == (1800.0, 1620.0, 698.61)
    assert rec["power_instant_w_median"] == 707.87 and rec["temperature_c_max"] == 58.0
    assert rec["reasons"] == "0x4" and rec["reasons_active"] == ["sw_power_cap"]
    assert rec["spacing_ms"] == pytest.approx(50, abs=1)
    none = card.summarize(s[2:])
    assert none["samples"] == 1 and none["sm_mhz_median"] is None and none["reasons"] is None
    assert card.reason_names(0x1 | 0x4 | 0x400) == ["gpu_idle", "sw_power_cap", "0x400"]
    with pytest.raises(ValueError, match="does not have"):
        card.parse_lines(f"{stamp(t)}, 1980\n", fields)


FAKE_SMI = """#!{python}
import os, signal, sys, time
args = sys.argv[1:]
if os.environ.get("FAKE_SMI_EXIT"):
    print("No devices were found", file=sys.stderr)
    sys.exit(int(os.environ["FAKE_SMI_EXIT"]))
if args == ["--help-query-gpu"]:
    print({help!r})
    sys.exit(0)
if args[0] == "--query-gpu=name,power.limit":
    print("card zero, 700.00 W\\ncard one, 500.00 W")
    sys.exit(0)
assert args[0] == "--query-gpu={query}" and args[3] == "--id=GPU-fake", args
signal.signal(signal.SIGINT, lambda *a: sys.exit(0))
for line in open(os.environ["FAKE_SMI_LINES"]):
    print(line, end="", flush=True)
while True:
    time.sleep(0.01)
"""


@pytest.fixture
def fake_smi(tmp_path, monkeypatch):
    """A fake nvidia-smi that prints the lines of ``lines.csv`` and then
    waits for SIGINT, as ``nvidia-smi -lms`` samples until stopped."""
    fields, _ = card.choose_fields(card.listed_fields(HELP_EVENT))
    path = tmp_path / "nvidia-smi"
    path.write_text(FAKE_SMI.format(python=sys.executable, help=HELP_EVENT,
                                    query=",".join(fields)))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("FAKE_SMI_LINES", str(tmp_path / "lines.csv"))
    return path, tmp_path / "lines.csv"


def test_sampler_windows_by_time_stamp(fake_smi):
    smi, lines = fake_smi
    t = time.time() - 10
    rows = [(0.0, "345", "75.4", "0x1"), (1.0, "1980", "130.5", "0x0"),
            (1.05, "1620", "699.5", "0x4"), (1.1, "[N/A]", "[N/A]", "[N/A]"),
            (2.0, "1980", "131.0", "0x0")]
    lines.write_text("".join(f"{stamp(t + dt)}, {sm}, 2619, {p}, 40, [N/A], {r}\n"
                             for dt, sm, p, r in rows))
    with card.ClockSampler("GPU-fake", interval_ms=20, smi=str(smi)) as sampler:
        deadline = time.time() + 20
        while len(sampler.samples()) < len(rows) and time.time() < deadline:
            time.sleep(0.02)
        live = sampler.window(t + 0.9, t + 1.2)
    after = sampler.window(t + 0.9, t + 1.2)
    assert live == after
    assert after["samples"] == 3 and after["sm_samples"] == 2
    assert (after["sm_mhz_median"], after["sm_mhz_min"]) == (1800.0, 1620.0)
    assert after["power_instant_w_median"] is None and after["reasons_active"] == ["sw_power_cap"]
    assert sampler.window(t + 5, t + 6)["samples"] == 0
    assert sampler.fields["reasons"] == "clocks_event_reasons.active"
    assert sampler._proc.poll() is not None  # stopped with the block
    assert card.card_name(1, smi=str(smi)) == "card one, 500.00 W"


def test_sampler_raises_without_nvidia_smi(tmp_path, fake_smi, monkeypatch):
    with pytest.raises(RuntimeError, match="help-query-gpu"):
        card.ClockSampler("GPU-fake", smi=str(tmp_path / "absent")).__enter__()
    with pytest.raises(FileNotFoundError):
        card.card_name(smi=str(tmp_path / "absent"))
    smi, _ = fake_smi
    monkeypatch.setenv("FAKE_SMI_EXIT", "6")
    with pytest.raises(RuntimeError, match="help-query-gpu"):
        card.ClockSampler("GPU-fake", smi=str(smi)).__enter__()


def test_sampler_raises_when_nvidia_smi_stops(fake_smi, monkeypatch):
    """An nvidia-smi that exits inside the block (here: no device by that
    id) is an error, never an empty or zero reading."""
    smi, lines = fake_smi
    monkeypatch.setenv("FAKE_SMI_LINES", "/nonexistent/lines.csv")
    with pytest.raises(RuntimeError, match="exited"):
        with card.ClockSampler("GPU-fake", smi=str(smi)) as sampler:
            deadline = time.time() + 20
            while sampler._proc.poll() is None and time.time() < deadline:
                time.sleep(0.02)
            sampler.samples()
    with pytest.raises(RuntimeError, match="exited"):
        with card.ClockSampler("GPU-fake", smi=str(smi)) as sampler:
            sampler._proc.wait(timeout=20)


def test_not_measured_has_every_field_none():
    rec = card.not_measured("no card")
    assert set(rec) == set(card.summarize([])) | {"note"}
    assert all(v is None for k, v in rec.items() if k != "note")
    assert rec["note"] == "not measured: no card"


@pytest.mark.parametrize("k_short,k_long", tool.DIFF_LENGTHS)
def test_differenced_time_on_a_fake_clock(k_short, k_long):
    """A run of k launches that costs 7.5 ms once and 1.25 ms a launch
    differences to 1.25 ms."""
    calls = []

    def timed(k):
        calls.append(k)
        return 7.5 + 1.25 * k

    assert tool.diff_ms(timed, k_short, k_long) == pytest.approx(1.25)
    assert calls == [k_short, k_long]


def test_operation_counts_and_shares_match_the_bounds():
    ops = bounds.count_ops(1024, 1024, 3128)
    assert ops == 10 * 1024 * 1024 * 32 * 3128
    bound_ms, by = bounds.count_bound(1024, 1024, 3128)
    assert by == "operations" and bound_ms == pytest.approx(1e3 * ops / bounds.PEAK_INT8_OPS)
    r = {"ms": 1.1, **tool.bound_fields(tool.CARD, 3128)}
    tool.rate_fields(r, ops, 900.0, on_card=True)
    assert r["tops"] == pytest.approx(ops / 1.1e-3 / 1e12)
    assert r["share_of_bound"] == pytest.approx(bound_ms / 1.1)
    assert r["share_of_measured_int8"] == pytest.approx(r["tops"] / 900.0)
    cpu = {"ms": 1.1, "bound_ms": bound_ms}
    tool.rate_fields(cpu, ops, None, on_card=False)
    assert cpu["tops"] is cpu["share_of_bound"] is cpu["share_of_measured_int8"] is None
    rate, share = tool.matmul_rate("int8", 8192, 1.0)
    assert rate == pytest.approx(2 * 8192 ** 3 / 1e9) and share == pytest.approx(rate / 1979)
    rate, share = tool.matmul_rate("bf16", 8192, 2.0)
    assert bounds.PEAK_BF16_OPS == 989e12 and share == pytest.approx(rate / 989)


def test_data_kinds_come_from_the_seed():
    layout = PlaneLayout.create(100)
    make = lambda kind, seed=3: tool.kind_planes(kind, 8192, layout, seed, 512, 8)  # noqa: E731
    random, cloned, missing = make("random"), make("cloned"), make("missing")
    assert np.array_equal(random, make("random")) and not np.array_equal(random, make("random", 4))
    assert (planes_to_genotypes(missing, layout) == -1).all()  # every site missing
    fam = cloned[:, :4096].reshape(2, 512, 8, layout.words)
    assert (fam == fam[:, :, :1]).all()  # 512 families of 8 identical rows
    assert len({fam[:, f, 0].tobytes() for f in range(512)}) == 512
    assert np.array_equal(cloned[:, 4096:], random[:, 4096:])
    assert np.array_equal(cloned[:, ::8][:, :512], random[:, ::8][:, :512])
    pair = np.ascontiguousarray(missing[:, :128])
    counts, check = tool.checked_pair(torch.from_numpy(pair.view(np.int32)), 64)
    assert check == {"checksum": 0, "counters_equal_plain": True, "max_abs_err": 0}


@pytest.mark.parametrize("kind", tool.KINDS)
def test_pair_counters_equal_the_jax_kernel(kind):
    """On seeded planes (two panels of 64 rows, 300 sites) the probe's pair
    counters and checksum equal the JAX package's Pallas kernel in
    interpret mode (tests/test_torch_counts.py's settings), exactly."""
    import jax.numpy as jnp

    from cuking_tpu.ops.king_pallas import panel_counts_pallas

    planes = tool.kind_planes(kind, 128, PlaneLayout.create(300), 11, 8, 4)
    counts, check = tool.checked_pair(torch.from_numpy(planes.view(np.int32)), 64)
    ref = panel_counts_pallas(jnp.asarray(planes[:, :64]), jnp.asarray(planes[:, 64:]),
                              site_chunk_words=8, tile_i=8, tile_j=8, interpret=True)
    for got, want in zip(counts, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert check["checksum"] == sum(int(np.asarray(c, dtype=np.int64).sum()) for c in ref)
    assert check["counters_equal_plain"] and check["max_abs_err"] == 0


def test_cpu_run_prints_one_line_with_every_key():
    proc = subprocess.run([sys.executable, TOOL, "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert {"card", "torch", "cuda", "peak", "kernel", "engine", "launches_total",
            "checks_failed", "windows"} <= set(line)
    assert line["checks_failed"] == [] and line["device"]["platform"] == "cpu"
    assert set(line["peak"]) == set(tool.DTYPES)
    assert all(set(sets) == set(tool.OPERANDS) for sets in line["peak"].values())
    methods = {"sync", "async_x32", "events_repeat", "events_repeat_20", "events_cycle8",
               "diff_1_8", "diff_8_32", "diff_16_48"}
    for kind in tool.KINDS:
        k = line["kernel"][kind]
        assert set(k["methods"]) == methods and k["counters_equal_plain"]
        assert all(r["ms"] > 0 and r["share_of_bound"] is None for r in k["methods"].values())
    assert line["kernel"]["missing"]["checksum"] == 0
    assert line["engine"]["steps"] == 136 and line["engine"]["hits"] == 0
    assert len(line["windows"]) == 4 + 3 * len(methods) + 2
    for rec in line["windows"].values():
        assert rec["note"].startswith("not measured")
        assert all(v is None for k, v in rec.items() if k != "note")
    assert line["clock_fields"] is None


def test_no_card_exits_2_and_prints_no_number(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert tool.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not any(ch.isdigit() for ch in out.err.replace("torch.cuda", ""))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and its nvidia-smi")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sampler_reads_the_card_under_load(cuda_device):
    """The card's own nvidia-smi, selected by the UUID torch reports,
    samples its SM clock while a product runs."""
    a = torch.ones((4096, 4096), dtype=torch.bfloat16, device=cuda_device)
    props = torch.cuda.get_device_properties(cuda_device)
    with card.ClockSampler(card.smi_id(props)) as sampler:
        t0 = time.time()
        while time.time() - t0 < 1.0:
            a @ a
        torch.cuda.synchronize()
        t1 = time.time()
    rec = sampler.window(t0, t1)
    assert rec["sm_samples"] >= 5 and rec["sm_mhz_min"] > 0 and rec["power_w_max"] > 0
