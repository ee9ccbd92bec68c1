"""The comparison that decides ``correct``: each number compared beside its
limit.

A cell's driver reduces its answers and the reference's to arrays of dB
values and ok flags over the sampled instances; this module turns them
into the numbers that are judged:

- ``<name>_gap_db``: the widest gap, in dB, between an answer and the
  reference, over every compared value that both sides hold finite;
- ``ok_mismatch``: how many compared instances the program and the
  reference disagree on, failed against finished, or a value finite on one
  side only (limit 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Check:
    """One number compared and its limit; ``passed`` when it is at most the
    limit (a number that is not finite never passes)."""

    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Gap:
    """The widest gap between the program's values and the reference's,
    accumulated over every job of the window."""

    def __init__(self):
        self.widest = 0.0
        self.mismatched = 0
        self.compared = 0

    def add(self, program_db, reference_db, program_ok, reference_ok) -> None:
        """Fold in one job's values: ``*_db`` of any shape whose leading
        axis is the instance, ``*_ok`` one flag an instance."""
        p, r = np.asarray(program_db, dtype=np.float64), np.asarray(reference_db, dtype=np.float64)
        po, ro = np.asarray(program_ok, dtype=bool), np.asarray(reference_ok, dtype=bool)
        self.mismatched += int(np.count_nonzero(po != ro))
        both = np.broadcast_to((po & ro).reshape(po.shape + (1,) * (p.ndim - po.ndim)), p.shape)
        fp, fr = np.isfinite(p), np.isfinite(r)
        # an instance both call finished whose value only one side holds finite
        self.mismatched += int(np.count_nonzero((both & (fp != fr)).reshape(len(po), -1).any(1)))
        both = both & fp & fr
        self.compared += int(np.count_nonzero(both))
        if both.any():
            self.widest = max(self.widest, float(np.max(np.abs(p[both] - r[both]))))

    def checks(self, name: str, limit_db: float) -> Dict[str, Check]:
        """``{<name>_gap_db, ok_mismatch}``; with nothing compared the gap
        reads infinite, so an empty comparison never passes."""
        widest = self.widest if self.compared else math.inf
        return {f"{name}_gap_db": Check(widest, limit_db),
                "ok_mismatch": Check(float(self.mismatched), 0.0)}


def db(power) -> np.ndarray:
    """10 log10 of a power, NaN where it is not positive and finite."""
    p = np.asarray(power, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(np.isfinite(p) & (p > 0), 10.0 * np.log10(np.where(p > 0, p, 1.0)),
                        np.nan)


def render(checks: Dict[str, Check]) -> List[str]:
    """One line a number: ``<name> <value> limit <limit>``."""
    return [f"{k} {c.value!r} limit {c.limit!r}" for k, c in checks.items()]


def sample_rows(rng, n: int, count: int, blocks: int = 1) -> np.ndarray:
    """``count`` distinct rows of ``n``, drawn from ``rng`` evenly over
    ``blocks`` equal blocks (the shards of a batch split over cards), so
    that every block has rows in the sample; sorted."""
    count = min(int(count), n)
    edges = np.linspace(0, n, int(blocks) + 1).astype(np.int64)
    per = np.diff(np.linspace(0, count, int(blocks) + 1).astype(np.int64))
    return np.sort(np.concatenate([lo + rng.choice(hi - lo, size=min(k, hi - lo), replace=False)
                                   for lo, hi, k in zip(edges[:-1], edges[1:], per)]))
