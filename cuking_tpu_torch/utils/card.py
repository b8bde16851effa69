"""The card's name, and its clocks and power sampled while work runs, read
through ``nvidia-smi`` (stdlib only: no torch).

:func:`card_name` is the line that every reading of the port is stated
beside: the card's name and power limit.  :class:`ClockSampler` runs
``nvidia-smi --query-gpu=... -lms <ms>`` in the background for one card and
summarises the samples that fall between two ``time.time()`` stamps
(:meth:`ClockSampler.window`): the SM clock, the memory clock, the power
draw, the temperature and the union of the clock event (throttle) reasons.
A card running below its clock for want of power shows the ``sw_power_cap``
reason.

The card is named to ``nvidia-smi -i`` by its UUID, taken from
``torch.cuda.get_device_properties(i).uuid`` (:func:`smi_id`), never by an
index, which ``CUDA_VISIBLE_DEVICES`` can renumber.  The PCI bus id would do
too where ``nvidia-smi`` reads one; the H100 machines the port is measured
on report it as ``[N/A]`` and find no device by it.

A field that ``nvidia-smi`` cannot read (``[N/A]``, ``[Not Supported]``)
becomes ``None``, never 0.  A sampler whose ``nvidia-smi`` is missing or
exits on its own raises: it never reports zeros.
"""

from __future__ import annotations

import datetime
import functools
import operator
import os
import re
import signal
import statistics
import subprocess
import tempfile

SMI = "nvidia-smi"

# Clock event reasons (NVML's nvmlClocksEventReason* bits), by bit.
REASON_BITS = {
    0x1: "gpu_idle",
    0x2: "applications_clocks_setting",
    0x4: "sw_power_cap",
    0x8: "hw_slowdown",
    0x10: "sync_boost",
    0x20: "sw_thermal_slowdown",
    0x40: "hw_thermal_slowdown",
    0x80: "hw_power_brake_slowdown",
    0x100: "display_clock_setting",
}
# The reasons field by its current name, then by its name in older nvidia-smi.
REASON_FIELDS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")
INSTANT_POWER_FIELD = "power.draw.instant"
# nvidia-smi fields -> the keys of a sample, always sampled; choose_fields
# adds the instant power and the reasons where nvidia-smi lists them.
BASE_FIELDS = {
    "timestamp": "t",
    "clocks.sm": "sm_mhz",
    "clocks.mem": "mem_mhz",
    "power.draw": "power_w",
    "temperature.gpu": "temperature_c",
}
UNREADABLE = {"", "N/A", "[N/A]", "[Not Supported]", "Not Supported", "[Unknown Error]"}


def card_name(index: int = 0, smi: str = SMI) -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for card ``index``, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``.  Raises when ``nvidia-smi`` is
    missing or fails."""
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[index]


def smi_id(props) -> str:
    """The ``nvidia-smi -i`` id of the card whose
    ``torch.cuda.get_device_properties(i)`` is ``props``: its UUID."""
    return f"GPU-{props.uuid}"


def listed_fields(help_text: str) -> set:
    """The field names that ``nvidia-smi --help-query-gpu`` lists (each in
    double quotes; a field with two names lists both)."""
    return set(re.findall(r'"([A-Za-z0-9_.]+)"', help_text))


def choose_fields(listed: set) -> tuple[dict, dict]:
    """(nvidia-smi field -> sample key, in query order; what each reported
    field is, with the reason for any that is not sampled)."""
    fields = dict(BASE_FIELDS)
    about = {"power_w": "power.draw (nvidia-smi may average it over ~1 s)"}
    if INSTANT_POWER_FIELD in listed:
        fields[INSTANT_POWER_FIELD] = "power_instant_w"
        about["power_instant_w"] = INSTANT_POWER_FIELD
    else:
        about["power_instant_w"] = None
        about["power_instant_w_note"] = f"this nvidia-smi does not list {INSTANT_POWER_FIELD}"
    reasons = next((f for f in REASON_FIELDS if f in listed), None)
    about["reasons"] = reasons
    if reasons:
        fields[reasons] = "reasons"
    else:
        about["reasons_note"] = f"this nvidia-smi lists neither {' nor '.join(REASON_FIELDS)}"
    return fields, about


def parse_value(text: str) -> float | None:
    text = text.strip()
    return None if text in UNREADABLE else float(text)


def parse_reasons(text: str) -> int | None:
    text = text.strip()
    return None if text in UNREADABLE else int(text, 16)


def parse_timestamp(text: str) -> float:
    """``2026/10/17 17:19:59.687`` (the local time, as nvidia-smi prints
    it) -> seconds since the epoch, as ``time.time()`` counts them."""
    return datetime.datetime.strptime(text.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()


def parse_lines(text: str, fields: dict) -> list[dict]:
    """Samples from ``--format=csv,noheader,nounits`` lines of ``fields``
    (nvidia-smi field -> key); a last line without its newline is still
    being written and is left out."""
    keys = list(fields.values())
    lines = text.split("\n")[:-1]
    samples = []
    for line in lines:
        if not line.strip():
            continue
        cols = line.split(",")
        if len(cols) != len(keys):
            raise ValueError(f"nvidia-smi line {line!r} does not have the {len(keys)} "
                             f"fields {list(fields)}")
        sample = {}
        for key, col in zip(keys, cols):
            if key == "t":
                sample[key] = parse_timestamp(col)
            elif key == "reasons":
                sample[key] = parse_reasons(col)
            else:
                sample[key] = parse_value(col)
        samples.append(sample)
    return samples


def reason_names(bits: int | None) -> list | None:
    if bits is None:
        return None
    names = [name for bit, name in REASON_BITS.items() if bits & bit]
    rest = bits & ~sum(REASON_BITS)
    return names + ([f"0x{rest:x}"] if rest else [])


def _readable(samples: list, key: str) -> list:
    return [s[key] for s in samples if s.get(key) is not None]


def summarize(samples: list) -> dict:
    """One window's clock record: the sample count and their median
    spacing, the SM clock (median, min; and how many samples read it), the
    memory clock, the power (median, max; also the instant power where
    sampled), the highest temperature, and the union of the reason bits.
    A field that no sample could read is ``None``."""
    def pick(key, fn):
        vals = _readable(samples, key)
        return fn(vals) if vals else None

    times = [s["t"] for s in samples]
    gaps = [1e3 * (b - a) for a, b in zip(times, times[1:])]
    reasons = _readable(samples, "reasons")
    union = functools.reduce(operator.or_, reasons) if reasons else None
    return {
        "samples": len(samples),
        "spacing_ms": statistics.median(gaps) if gaps else None,
        "sm_samples": len(_readable(samples, "sm_mhz")),
        "sm_mhz_median": pick("sm_mhz", statistics.median),
        "sm_mhz_min": pick("sm_mhz", min),
        "mem_mhz_median": pick("mem_mhz", statistics.median),
        "power_w_median": pick("power_w", statistics.median),
        "power_w_max": pick("power_w", max),
        "power_instant_w_median": pick("power_instant_w", statistics.median),
        "power_instant_w_max": pick("power_instant_w", max),
        "temperature_c_max": pick("temperature_c", max),
        "reasons": None if union is None else f"0x{union:x}",
        "reasons_active": reason_names(union),
    }


def not_measured(why: str) -> dict:
    """A window record with every field ``None`` and the reason, for a run
    with no card to sample."""
    record = {key: None for key in summarize([])}
    record["note"] = f"not measured: {why}"
    return record


class ClockSampler:
    """Samples one card's clocks, power, temperature and clock event
    reasons every ``interval_ms`` while the ``with`` block runs::

        with ClockSampler(smi_id(torch.cuda.get_device_properties(0))) as s:
            t0 = time.time(); work(); t1 = time.time()
        record = s.window(t0, t1)

    ``fields`` says what each sampled key is (which power field, which
    reasons field, and why one is missing).  The ``nvidia-smi`` process is
    stopped when the block ends, whatever ends it."""

    def __init__(self, device_id: str, interval_ms: int = 50, smi: str = SMI):
        self.device_id = device_id
        self.interval_ms = interval_ms
        self.smi = smi
        self.fields: dict = {}
        self._query: dict = {}
        self._proc = None
        self._out = self._err = None
        self._text = ""

    def __enter__(self) -> "ClockSampler":
        try:
            help_text = subprocess.run([self.smi, "--help-query-gpu"], capture_output=True,
                                       text=True, check=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            raise RuntimeError(f"cannot sample the card's clocks: {self.smi} --help-query-gpu "
                               f"failed: {e}") from e
        self._query, self.fields = choose_fields(listed_fields(help_text))
        self._out, self._err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        try:
            self._proc = subprocess.Popen(
                [self.smi, f"--query-gpu={','.join(self._query)}",
                 "--format=csv,noheader,nounits", f"-lms={self.interval_ms}",
                 f"--id={self.device_id}"],
                stdout=self._out, stderr=self._err)
        except OSError as e:
            self._close_files()
            raise RuntimeError(f"cannot start {self.smi}: {e}") from e
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        died = self._proc.poll()
        if died is None:  # still sampling, as it should be: stop it
            self._proc.send_signal(signal.SIGINT)
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._text = self._read(self._out)
        err = self._read(self._err)
        self._close_files()
        if died is not None and exc_type is None:
            raise RuntimeError(f"{self.smi} exited {died} while sampling "
                               f"{self.device_id}: {err.strip()}")

    @staticmethod
    def _read(f) -> str:
        # pread leaves the offset that nvidia-smi shares with f untouched.
        fd = f.fileno()
        return os.pread(fd, os.fstat(fd).st_size, 0).decode(errors="replace")

    def _close_files(self) -> None:
        for f in (self._out, self._err):
            if f is not None:
                f.close()
        self._out = self._err = None

    def samples(self) -> list[dict]:
        """Every sample so far (all of them once the block has ended).
        Raises when ``nvidia-smi`` has stopped on its own inside the block."""
        if self._out is None:
            return parse_lines(self._text, self._query)
        if self._proc.poll() is not None:
            raise RuntimeError(f"{self.smi} exited {self._proc.returncode} while sampling "
                               f"{self.device_id}: {self._read(self._err).strip()}")
        text = self._read(self._out)
        return parse_lines(text, self._query)

    def window(self, t0: float, t1: float) -> dict:
        """The clock record (:func:`summarize`) of the samples stamped in
        ``[t0, t1]`` (``time.time()`` seconds)."""
        return summarize([s for s in self.samples() if t0 <= s["t"] <= t1])
