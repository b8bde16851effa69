"""A cell over several cards: the device string a mode is handed, every
card synchronised at a unit's end, the fullest card's peak, and a card's
mean busy time and idle share over the cell's cards, with one card's
readings bit for bit the one-card expressions.  On the CPU through the
functions ``run.py`` and ``tracing.py`` use and a throwaway mode; on two
cards or more (marked ``gpu``) through ``run_cell`` with a mode that
allocates a different size on each card and sleeps on the last."""

import sys
import types

import numpy as np
import pytest
import torch

from kingbench import run, tracing
from kingbench.tests.tiny import SEED

ROWS = np.array([[0, 1, 0, 0, 0, 0]], np.int64)


class ProbeSession:
    """A throwaway mode: each unit holds ``mib[k]`` MiB on card k and, where
    ``sleep_cycles`` is set, sleeps that many cycles on the last card; its
    one row is the reference's."""

    unit = "probe"
    handed: list = []

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.devices = config, device.split(",")
        ProbeSession.handed.append(device)

    def once(self) -> int:
        held = [torch.empty(mib << 20, dtype=torch.uint8, device=d)
                for d, mib in zip(self.devices, self.config["mib"])]
        if self.config["sleep_cycles"]:
            with torch.cuda.device(self.devices[-1]):
                torch.cuda._sleep(self.config["sleep_cycles"])
        del held
        return 0

    def ok(self, output: int) -> bool:
        return output == 0

    def end_to_end(self, units: int, wall: float) -> dict:
        return {"unit_s": wall / units}

    def layer_context(self, outputs: list) -> dict:
        return {}

    def notes(self, outputs: list) -> str:
        return ""

    def outputs_rows(self, outputs: list) -> list:
        return [ROWS for _ in outputs]

    def free(self) -> None:
        pass

    def reference(self) -> np.ndarray:
        return ROWS

    def close(self) -> None:
        pass


def run_probe(monkeypatch, chips: int, device: str, mib: list, sleep_cycles: int = 0,
              trace: bool = False) -> dict:
    """The probe mode's result as a cell of ``chips`` cards; what it was
    handed is in ``ProbeSession.handed``."""
    mode = types.ModuleType("kingbench.modes.probe")
    mode.Session = ProbeSession
    monkeypatch.setitem(sys.modules, "kingbench.modes.probe", mode)
    monkeypatch.setattr(ProbeSession, "handed", [])
    cell = {"name": "probe", "config": "probe", "traffic": "probe", "chips": chips,
            "why": "a throwaway cell"}
    manifest = {"workloads": [cell], "per_layer": [],
                "end_to_end": [{"name": n, "unit": u} for n, u in
                               (("setup_s", "s"), ("unit_s", "s"), ("peak_device_gib", "GiB"))]}
    if device == "cpu":  # no cards to number: each of the cell's is the CPU
        monkeypatch.setattr(run, "cards", lambda device, chips: [device] * chips)
    spec = (cell, {"mib": mib, "sleep_cycles": sleep_cycles}, {"mode": "probe"})
    return run.run_cell(manifest, "probe", SEED, 0.05, trace, device=device, spec=spec)


@pytest.mark.parametrize("device,chips,handed", [
    ("cuda", 1, "cuda"), ("cuda", 2, "cuda:0,cuda:1"), ("cuda", 4, "cuda:0,cuda:1,cuda:2,cuda:3"),
    ("cpu", 1, "cpu")])
def test_a_mode_is_handed_its_cards_as_device_takes_them(device, chips, handed):
    assert ",".join(run.cards(device, chips)) == handed


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_hands_the_mode_its_cards_and_counts_them(monkeypatch, chips, trace):
    r = run_probe(monkeypatch, chips, "cpu", [1] * chips, trace=trace)
    assert ProbeSession.handed == [",".join(["cpu"] * chips)]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == chips and r["device"]["memory_peak_bytes"] == 0
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "unit_s", "peak_device_gib"}


@pytest.mark.parametrize("chips", [1, 4])
def test_every_card_is_synchronised(monkeypatch, chips):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    run.synchronize(run.cards("cuda", chips))
    assert waited == (["cuda"] if chips == 1 else [f"cuda:{k}" for k in range(chips)])


@pytest.mark.parametrize("peaks,fullest", [
    ({"cuda": 4171760128}, 4171760128),
    ({"cuda:0": 5 << 30, "cuda:1": 46 << 30, "cuda:2": 45 << 30, "cuda:3": 0}, 46 << 30),
    ({"cuda:0": 7, "cuda:1": 3, "cuda:2": 3, "cuda:3": 3}, 7)])
def test_the_peak_is_the_fullest_cards(monkeypatch, peaks, fullest):
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", peaks.__getitem__)
    assert run.memory_peak(run.cards("cuda", len(peaks))) == (fullest, peaks)


def _trace(events: list, span_us: float) -> dict:
    return {"traceEvents": [{"ph": "X", "name": "kingbench.unit", "cat": "user_annotation",
                             "ts": 0.0, "dur": span_us}]
            + [{"ph": "X", "name": "king_counts_wgmma_kernel", "cat": "kernel", "ts": ts,
                "dur": dur, "args": {"device": card, "stream": 7}}
               for card, ts, dur in events],
            "deviceProperties": [{"id": k, "name": "card"} for k in range(4)]}


def test_busy_and_idle_over_four_cards_count_an_idle_card_as_idle():
    # Cards 0-2 busy 200, 250 and 100 us of 1,000; card 3 runs nothing.
    events = [(0, 100, 200), (1, 150, 100), (1, 200, 200), (2, 500, 100)]
    stats, dev, window = tracing.read_window(_trace(events, 1000.0))
    assert stats["busy_union_ms"] == pytest.approx(0.55)
    assert tracing.mean_busy_ms(stats, 4) == pytest.approx(0.1375)
    ctx = {"trace": stats, "chips": 4}
    assert tracing.idle_share(ctx) == pytest.approx(86.25)
    assert run.reader("device_idle_share.task")(ctx) == pytest.approx(86.25)
    # The gaps are the stretches in which no card ran anything.
    gaps = tracing.idle_gaps(dev, window, lambda t: "gap")
    assert [g[1] for g in gaps] == pytest.approx([400e-6, 100e-6, 100e-6])


@pytest.mark.parametrize("events,span_us", [
    ([(0, 0.1, 0.7), (0, 0.3, 33.3), (0, 1e5 / 3, 1e4 / 7)], 1e6 / 9),
    ([(0, 10.0, 5000.0), (0, 6000.0, 2e6 / 3)], 7e6 / 3)])
def test_one_card_reads_bit_for_bit_the_one_card_expressions(events, span_us):
    stats, _, _ = tracing.read_window(_trace(events, span_us))
    assert tracing.mean_busy_ms(stats, 1) / 1e3 == stats["busy_union_ms"] / 1e3
    want = 100 * (1 - stats["busy_union_ms"] / stats["trace_span_ms"])
    assert tracing.idle_share({"trace": stats, "chips": 1}) == want


@pytest.mark.gpu
def test_a_unit_waits_for_every_card_and_the_peak_is_the_fullest_cards(monkeypatch):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    cards = torch.cuda.device_count()
    mib = [256 if k == 1 else 32 * (k + 1) for k in range(cards)]
    cycles = 1_000_000_000
    with torch.cuda.device(cards - 1):
        torch.cuda._sleep(1000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        sleep_s = start.elapsed_time(end) / 1e3
    assert sleep_s > 0.1
    r = run_probe(monkeypatch, cards, "cuda", mib, sleep_cycles=cycles)
    assert ProbeSession.handed == [",".join(f"cuda:{k}" for k in range(cards))]
    assert r["correct"] and r["device"]["count"] == cards
    assert r["metrics"]["unit_s"]["value"] >= 0.9 * sleep_s, (r["metrics"], sleep_s)
    peaks = [torch.cuda.max_memory_allocated(k) for k in range(cards)]
    assert r["device"]["memory_peak_bytes"] == max(peaks) == peaks[1] >= 256 << 20
