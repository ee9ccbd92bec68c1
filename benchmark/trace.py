"""The traced run's events, read from the profiler's Chrome trace, and the
numbers every cell reports from them: the device's busy time, the window,
and the breakdown of device operations and idle gaps.

The profiler (``torch.profiler`` with CPU and CUDA activities) writes the
host's operators, the benchmark's own spans (``record_function``: the
window and each job) and, through CUPTI, every kernel, copy and memset the
card ran, all on one clock in microseconds.  Per-layer metric readers
(``benchmark/metrics/<name>.py``) take a :class:`Trace`.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

# the device's operation kinds in the trace: kernels, copies and memsets
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"
JOB_SPAN = "bench.job"


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    cat: str
    device: int
    start: float   # microseconds
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Cell:
    """What a reader may know of the cell: its configuration and traffic as
    loaded, the instances a job completes, and the cards it runs on."""

    name: str
    config: dict
    traffic: dict
    instances_per_job: int
    chips: int


class Trace:
    """The events of one traced window."""

    def __init__(self, events: Sequence[dict], cell: Cell):
        self.cell = cell
        self.device_ops: List[Op] = []
        self.host_ops: List[Op] = []
        windows, jobs = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            start = float(e["ts"])
            end = start + float(e["dur"])
            if cat in DEVICE_CATS:
                args = e.get("args") or {}
                dev = args.get("device", e.get("pid", 0))
                self.device_ops.append(Op(name, cat, int(dev), start, end))
            elif cat in HOST_CATS:
                if cat == "user_annotation" and name == WINDOW_SPAN:
                    windows.append((start, end))
                elif cat == "user_annotation" and name == JOB_SPAN:
                    jobs.append((start, end))
                else:
                    self.host_ops.append(Op(name, cat, -1, start, end))
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} '{WINDOW_SPAN}' spans, not one")
        self.window: Tuple[float, float] = windows[0]
        self.jobs: List[Tuple[float, float]] = sorted(jobs)
        w0, w1 = self.window
        self.device_ops = sorted((o for o in self.device_ops if o.end > w0 and o.start < w1),
                                 key=lambda o: o.start)
        self.host_ops = [o for o in self.host_ops if o.end > w0 and o.start < w1]

    # -- the window ------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    def devices(self) -> List[int]:
        """The cards the cell runs on: those with device operations in the
        window (at least the cell's count, card 0 first)."""
        seen = sorted({o.device for o in self.device_ops})
        return seen if len(seen) >= self.cell.chips else list(range(self.cell.chips))

    def ops(self, *, cat: Optional[Sequence[str]] = None,
            name_has: Optional[str] = None) -> List[Op]:
        """The device operations of the window of kind ``cat`` whose name
        holds ``name_has``."""
        return [o for o in self.device_ops
                if (cat is None or o.cat in cat) and (name_has is None or name_has in o.name)]

    def busy_intervals(self, device: int) -> List[Tuple[float, float]]:
        """The union of the device operations on ``device``, clipped to the
        window."""
        w0, w1 = self.window
        out: List[Tuple[float, float]] = []
        for o in self.device_ops:
            if o.device != device:
                continue
            s, e = max(o.start, w0), min(o.end, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the cell's cards."""
        devs = self.devices()
        total = sum(e - s for d in devs for s, e in self.busy_intervals(d))
        return total * 1e-6 / len(devs)

    # -- the breakdown ---------------------------------------------------------
    def top_device_ops(self, k: int = 10) -> List[list]:
        """The device operations that took most time, summed by name over
        every card, in seconds."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for o in self.device_ops:
            by_name[_short(o.name)] += o.dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v * 1e-6] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The idle time of card 0 in the window, summed by what the host
        was doing at each gap's middle (the innermost host operation or span
        open there; the job's own Python where none is, ``between jobs``
        outside every job), the largest ``k`` sums, in seconds."""
        dev = self.devices()[0]
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.busy_intervals(dev):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        host = sorted(self.host_ops, key=lambda o: o.start)
        starts = [o.start for o in host]
        job_starts = [s for s, _e in self.jobs]
        by_name: Dict[str, float] = collections.defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            # the innermost open operation is the shortest of those open at
            # the middle; nesting is shallow, so the last few to start hold it
            i = bisect.bisect_right(starts, mid)
            open_ops = [o for o in host[max(0, i - 64):i] if o.end >= mid]
            if open_ops:
                name = min(open_ops, key=lambda o: o.dur).name
            else:
                j = bisect.bisect_right(job_starts, mid) - 1
                name = JOB_SPAN if j >= 0 and self.jobs[j][1] >= mid else "between jobs"
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), v * 1e-6] for n, v in top]


def _short(name: str) -> str:
    """An operation's name without its argument list, its return type and
    anonymous namespaces: ``fwm4_rk_kernel<double, 0>``, ``Memcpy DtoH``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def load(path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
