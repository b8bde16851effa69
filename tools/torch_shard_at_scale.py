#!/usr/bin/env python3
"""One split-1 shard at a deployment's size through the port's engine on
one card, from host planes through the engine's own upload.

    python3 tools/torch_shard_at_scale.py                # the fit-limit shard
    python3 tools/torch_shard_at_scale.py --rows 69632   # chip_smoke.py phase 13a's

The shard has ``--rows`` samples (default: the most that
``utils/hbm.check_engine_fit`` admits on this card at the default
``KingConfig``, with the free memory read just before the check, unless the
host's available memory holds fewer) at 1,000,000 sites.  Its planes are
uniform random words drawn on the card from a fixed seed and copied into the host's ``PanelStorage``; clone families of 4
are planted at rows 0-3, across the first het row past word 2^31 and the
first hom row past word 2^32 (where they exist), in the last panel, and row
0 is cloned into the last row.  The whole sweep runs at threshold 0.0884 and
must return exactly the planted pairs, with kin == float32(0.5), ibs0 ==
ibs1 == 0 and each pair equal to the numpy oracle.  Prints the upload and
sweep times, pairs/s and ms per step, the peak device memory against
``check_engine_fit``'s model, the peak host RSS, the card's name and power
limit, and one JSON line last.  Exits 2 without a card.

``chip_smoke.py`` phase 13 builds its shards with these helpers.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

SITES = 1_000_000
SEED = 20261016
FAMILY = 4
# Available host bytes kept back from the planes for what the process
# allocates after them (in chip_smoke.py phase 13b its RSS grew 263 MiB
# past the planes; the reserve leaves room for more).
HOST_RESERVE_BYTES = 8 << 30


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def host_available_bytes() -> int:
    """``MemAvailable`` of /proc/meminfo, the host memory a new allocation
    can take without swapping."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) << 10
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def settled_host_available_bytes(timeout_s: float = 30.0) -> tuple[int, float]:
    """(``MemAvailable`` once it stops rising, seconds waited).  On the H100
    machine the memory that a process frees returns to ``MemAvailable`` over
    seconds (right after a 77 GB process exited, 45 of 101 GiB read free),
    so a reading taken at once can understate what the host holds."""
    t0 = time.perf_counter()
    last = host_available_bytes()
    while time.perf_counter() - t0 < timeout_s:
        time.sleep(1.0)
        now = host_available_bytes()
        if now - last < 256 << 20:
            return now, time.perf_counter() - t0
        last = now
    return last, time.perf_counter() - t0


def rss_bytes() -> tuple[int, int]:
    """(current, peak) resident host memory of this process."""
    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) << 10 for line in f if line.startswith("VmRSS:"))
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10


def shard_rows(words: int, config, card_limit: int, host_bytes: int) -> tuple[int, str, int]:
    """(rows, what set them, the host's rows): the most rows of a split-1
    shard that ``check_engine_fit`` admits under ``card_limit``, unless
    ``host_bytes`` of available host memory less ``HOST_RESERVE_BYTES``
    hold fewer panels of planes, and then the host's."""
    from tools.torch_capacity_plan import largest_diagonal_rows

    card = largest_diagonal_rows(words, card_limit, config)
    panel_bytes = 8 * config.panel * words
    host = max(0, host_bytes - HOST_RESERVE_BYTES) // panel_bytes * config.panel
    return (card, "card", host) if card <= host else (host, "host", host)


def fit_limit_rows(device, config) -> dict:
    """The fit-limit shard's size on ``device`` at 1,000,000 sites: the
    card's free and total memory and ``device_bytes_limit`` read now, the
    host's settled available memory, and :func:`shard_rows`' rows, what set
    them and the host's rows.  Release cached device blocks first."""
    import torch

    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.utils.hbm import device_bytes_limit

    free_b, total_b = torch.cuda.mem_get_info(device)
    limit = device_bytes_limit(device)
    host_b, settle_s = settled_host_available_bytes()
    rows, set_by, host_rows = shard_rows(PlaneLayout.create(SITES).words, config, limit,
                                         host_b)
    return {"free_bytes": free_b, "total_bytes": total_b, "bytes_limit": limit,
            "host_available_bytes": host_b, "host_settle_s": settle_s, "rows": rows,
            "rows_set_by": set_by, "host_rows": host_rows}


def fill_on_card(planes: np.ndarray, layout, seed: int, device, block: int = 4096) -> None:
    """Uniform random het/hom words, drawn on ``device`` from ``seed``,
    into the host's ``planes`` ([2, rows, W] uint32), padding sites set
    missing, in blocks of ``block`` rows: tens of GB take seconds this way
    and minutes through numpy's generator."""
    import torch

    from cuking_tpu_torch.utils.synthetic import padding_mask

    gen = torch.Generator(device=device).manual_seed(seed)
    pad = torch.from_numpy(padding_mask(layout).view(np.int32)).to(device)
    for lo in range(0, planes.shape[1], block):
        hi = min(lo + block, planes.shape[1])
        for p in range(2):
            words = torch.randint(-2**31, 2**31 - 1, (hi - lo, layout.words),
                                  generator=gen, dtype=torch.int32, device=device)
            torch.from_numpy(planes[p, lo:hi].view(np.int32)).copy_(words.bitwise_or_(pad))
    del words
    torch.cuda.empty_cache()  # the fit check reads the free memory next


def family_groups(rows: int, words: int) -> list:
    """The clone families of the shard: rows 0-3, across the first het row
    past word 2^31 and the first hom row past word 2^32 (each family holds
    the row that straddles the limit and the first one past it), the last
    panel's last family, and row 0's clone in the last row."""
    from cuking_tpu_torch.utils.synthetic import rows_past_word_limits

    groups = [range(0, FAMILY)]
    for row in rows_past_word_limits(rows, words):
        if 0 < row < rows and FAMILY <= row - 2 and row + 2 < rows - FAMILY:
            groups.append(range(row - 2, row + 2))
    groups += [range(rows - 1 - FAMILY, rows - 1), (0, rows - 1)]
    return groups


def deployment_storage(rows: int, sites: int, seed: int, device, families: bool = True):
    """A split-1 ``PanelStorage`` of ``rows`` x ``sites`` with planes made
    by :func:`fill_on_card`, and the planted pairs (none without
    ``families``).  ``rows`` is a multiple of the panel (1024)."""
    from cuking_tpu_torch.models.king import PanelStorage
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.synthetic import plant_clone_families

    layout = PlaneLayout.create(sites)
    storage = PanelStorage(layout, Submatrix.create(rows, 1, 0), 1024)
    check(storage.nr_pad == rows, f"{rows} rows are not a multiple of the panel")
    fill_on_card(storage.planes, layout, seed, device)
    planted = []
    if families:
        planted = plant_clone_families(storage.planes, family_groups(rows, layout.words))
    storage.mark_mutated()
    return storage, planted


def check_planted(rs, storage, planted: list) -> None:
    """Exactly the planted pairs, each with kin == float32(0.5) bit for
    bit, ibs0 == ibs1 == 0, ibs2 == the row's defined sites, and every field
    equal to the numpy oracle on the rows decoded from the host planes."""
    from cuking_tpu_torch.ops.bitset import planes_to_genotypes
    from cuking_tpu_torch.ops.oracle import oracle_king

    got = list(zip(rs.i_idx.tolist(), rs.j_idx.tolist()))
    check(got == planted, f"the sweep returned {len(got)} pairs, not the {len(planted)} "
                          f"planted ({sorted(set(got) ^ set(planted))[:8]} differ)")
    half = np.float32(0.5).view(np.uint32)
    check(bool(np.all(rs.kin.view(np.uint32) == half)), "a planted kin is not float32(0.5)")
    check(bool(np.all(rs.ibs0 == 0) and np.all(rs.ibs1 == 0)), "a planted ibs0/ibs1 is not 0")
    rows = sorted({r for pair in planted for r in pair})
    at = {r: k for k, r in enumerate(rows)}
    g = planes_to_genotypes(storage.planes[:, rows], storage.layout)
    for n, (i, j) in enumerate(planted):
        kin, ibs0, ibs1, ibs2 = oracle_king(g[at[i]:at[i] + 1], g[at[j]:at[j] + 1])
        check(int(rs.ibs2[n]) == int((g[at[i]] >= 0).sum()), f"ibs2 of ({i}, {j})")
        check(rs.kin[n].view(np.uint32) == kin[0, 0].view(np.uint32)
              and (rs.ibs0[n], rs.ibs1[n], rs.ibs2[n])
              == (ibs0[0, 0], ibs1[0, 0], ibs2[0, 0]),
              f"({i}, {j}) differs from the oracle")


def timed_upload(engine) -> dict:
    """Frees the allocator's cached blocks, resets the peak device memory
    and uploads ``engine``'s planes (``planes_dev``), timed by the host
    clock to a synchronize.  Returns the upload time, the device memory
    allocated before it (the base of :func:`peak_within_model`) and the
    host RSS (current, peak) before and after.  Launches no kernel."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rss_before = rss_bytes()
    t = time.perf_counter()
    engine.planes_dev
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    return {"upload_s": upload_s, "base": base, "rss_before": rss_before,
            "rss_after": rss_bytes()}


def peak_within_model(engine, base: int) -> tuple[int, int]:
    """(peak device memory since :func:`timed_upload` less its ``base``,
    ``check_engine_fit``'s model of the engine's shard); checks the first
    is within the second."""
    import torch

    from cuking_tpu_torch.utils.hbm import engine_plane_bytes, sweep_buffer_bytes

    storage, config = engine.storage, engine.config
    peak = torch.cuda.max_memory_allocated() - base
    model = (engine_plane_bytes(storage.submatrix, storage.layout.words, config.panel)
             + sweep_buffer_bytes(config))
    check(peak <= model, f"peak device memory {peak} B over check_engine_fit's model "
                         f"{model} B")
    return peak, model


def sweep_and_check(storage, planted: list, config) -> tuple[object, dict]:
    """Uploads ``storage``'s planes through a new ``KingEngine``
    (:func:`timed_upload`) and sweeps them whole, timed by the host clock to
    a synchronize; checks the planted pairs (:func:`check_planted`) and the
    peak device memory against ``check_engine_fit``'s model.  Returns the
    engine and its numbers."""
    import torch

    from cuking_tpu_torch.models.king import KingEngine
    from cuking_tpu_torch.utils.stopwatch import StageLogger

    engine = KingEngine(storage, config, logger=StageLogger(stream=sys.stderr))
    up = timed_upload(engine)
    t = time.perf_counter()
    rs = engine.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    check_planted(rs, storage, planted)
    steps = len(engine._panel_pair_params())
    peak, model = peak_within_model(engine, up["base"])
    rows = storage.nr
    return engine, {
        "upload_s": up["upload_s"], "sweep_s": sweep_s, "steps": steps,
        "step_ms": 1e3 * sweep_s / steps, "pairs_per_s": rows * (rows - 1) // 2 / sweep_s,
        "hits": len(rs), "peak_device_bytes": peak, "model_bytes": model,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=0,
                    help="samples of the shard, a multiple of 1024 (default: the fit limit)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_shard_at_scale: no CUDA device", file=sys.stderr)
        return 2
    from cuking_tpu_torch.models.king import KingConfig
    from tools.torch_baseline_parity import card_line

    card = card_line()
    dev = torch.device("cuda", 0)
    config = KingConfig(kernel="cuda", device="cuda")
    size = fit_limit_rows(dev, config)
    rows = args.rows or size["rows"]
    bound_by = "--rows" if args.rows else size["rows_set_by"]
    t = time.perf_counter()
    storage, planted = deployment_storage(rows, SITES, SEED, dev)
    make_s = time.perf_counter() - t
    _, swept = sweep_and_check(storage, planted, config)
    report = {
        **size, "rows": rows, "sites": SITES, "words": storage.layout.words,
        "rows_set_by": bound_by, "plane_bytes": storage.planes.nbytes, "make_s": make_s,
        **swept, "peak_rss_bytes": rss_bytes()[1], "card": card,
    }
    print(f"{rows:,} x {SITES:,} ({bound_by}): exactly the {len(planted)} planted "
          f"pairs; made in {make_s:.1f} s, uploaded {storage.planes.nbytes / 1e9:.2f} GB in "
          f"{swept['upload_s']:.2f} s, swept {swept['steps']:,} steps in "
          f"{swept['sweep_s']:.2f} s ({swept['step_ms']:.3f} ms per step, "
          f"{swept['pairs_per_s']:,.0f} pairs/s); peak device memory "
          f"{swept['peak_device_bytes'] / 2**20:,.0f} MiB of the model's "
          f"{swept['model_bytes'] / 2**20:,.0f}; peak host RSS "
          f"{report['peak_rss_bytes'] / 2**20:,.0f} MiB ({card})", file=sys.stderr)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
