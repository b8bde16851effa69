"""The comparison that decides ``correct``: a run's rows against the
reference's, exactly.

Rows are int64 (i, j, kin bits, ibs0, ibs1, ibs2).  Each number compared
counts rows over every output that the window produced, and its limit is
0: kin is compared as float32 bits and the counters as integers, so a row
of the port either is the reference's or it is not.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("missing_rows", "extra_rows", "differing_rows", "unsorted_rows")
LIMITS = dict.fromkeys(NUMBERS, 0)


def _keys(rows: np.ndarray) -> np.ndarray:
    return rows[:, 0] * (1 << 32) + rows[:, 1]


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """Rows of ``want`` that ``got`` lacks, rows of ``got`` that ``want``
    lacks (a pair written twice counts once more), rows of one pair that
    differ, and places where a row of ``got`` follows one of a later pair
    (the port sorts by (i, j, kin), and a pair is one row)."""
    gk, wk = _keys(got), _keys(want)
    common, gi, wi = np.intersect1d(gk, wk, return_indices=True)
    return {
        "missing_rows": int(len(want) - len(common)),
        "extra_rows": int(len(got) - len(common)),
        "differing_rows": int(np.count_nonzero((got[gi, 2:] != want[wi, 2:]).any(axis=1))),
        "unsorted_rows": int(np.count_nonzero(gk[1:] < gk[:-1])),
    }


def total(readings: list[dict]) -> dict:
    """The sum of each number over a window's outputs."""
    return {k: sum(r[k] for r in readings) for k in NUMBERS}


def correct(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in NUMBERS)
