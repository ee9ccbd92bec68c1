"""Shared reading of the port's own spans and counters in a traced window.

The port names each host step of a call with a span
(``torch.profiler.record_function``, category ``user_annotation`` in the
trace) called ``psa.<layer>[.<step>]``, nested so that the innermost span
open at any moment is the step that runs, and marks a counter as a
zero-length span ``psa.count <layer> <key>=<int> ...`` (the port's
``utils/observability``).  Spans share the profiler's clock with the
device's operations.  Readers of the program's host layers take:

- :func:`spans`: the window's ``psa.`` spans, marks left out;
- :func:`self_times`: each span's duration less what its ``psa.`` children
  cover;
- :func:`per_job_ms`: the self time of the chosen spans, summed over the
  spans that lie in a job (``trace.jobs``), per job;
- :func:`idle_outside_spans`: card 0's idle time inside the window's jobs,
  and the part of it that no ``psa.`` span covers;
- :func:`marks`: the parsed counters of one layer.

Each returns None, or nothing, where the trace holds no device operation
(a run off the card, where the kernels' plain versions run on the host and
the split means something else) or the program has no such span or mark.
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "psa."
COUNT = "psa.count"
ANNOTATION = "user_annotation"

# the host layers' spans, as the port names them
ENTRY = ("psa.sweep.spectrum", "psa.solve_comb_batch", "psa.make_comb_coeffs")
INPUTS = ENTRY + ("psa.sweep.plan", "psa.sweep.inputs", "psa.nwave.inputs")
WAIT = ("psa.wait",)
ASSEMBLY = ("psa.fetch", "psa.sweep.gain")
MESH = ("psa.mesh.shard", "psa.mesh.gather")
# a kernel's wrapper on the CUDA route (``launch``) or its plain torch
# version on the same device (``plain``): the kernel layer's host side
LAUNCH = re.compile(r"psa\.k\w+\.(launch|plain)")


def spans(trace) -> list:
    """The window's ``psa.`` spans (host operations), by start, an enclosing
    span before the spans it holds."""
    out = [o for o in trace.host_ops if o.cat == ANNOTATION and o.name.startswith(PREFIX)
           and not o.name.startswith(COUNT)]
    return sorted(out, key=lambda o: (o.start, -o.end))


def self_times(ordered) -> List[Tuple[object, float]]:
    """``[(span, self time in microseconds)]``: each span's duration less
    the durations of the spans directly inside it.  Spans of one thread
    either nest or are disjoint, so a span lies inside the innermost open
    span that ends after it starts."""
    own: Dict[int, float] = {}
    stack: List[int] = []
    for i, o in enumerate(ordered):
        while stack and ordered[stack[-1]].end <= o.start:
            stack.pop()
        own[i] = o.dur
        if stack:
            own[stack[-1]] -= o.dur
        stack.append(i)
    return [(o, max(own[i], 0.0)) for i, o in enumerate(ordered)]


def per_job_ms(trace, select: Callable[[str], bool]) -> Optional[float]:
    """The self time of the spans whose name ``select`` takes, summed over
    those that start inside a job, over the window's jobs, in ms; None off
    the card, without jobs, or without such a span."""
    if not trace.device_ops or not trace.n_jobs:
        return None
    chosen = [(o, t) for o, t in self_times(spans(trace)) if select(o.name)]
    starts = [s for s, _e in trace.jobs]
    total, found = 0.0, False
    for o, t in chosen:
        j = bisect.bisect_right(starts, o.start) - 1
        if j >= 0 and o.end <= trace.jobs[j][1]:
            total += t
            found = True
    if not found:
        return None
    return 1e-3 * total / trace.n_jobs


def named(*names: str) -> Callable[[str], bool]:
    chosen = frozenset(names)
    return lambda name: name in chosen


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_outside_spans(trace) -> Optional[Tuple[float, float]]:
    """``(idle, idle outside every psa. span)`` of card 0 inside the
    window's jobs, in microseconds; None off the card, without jobs or
    without a ``psa.`` span.  The gaps between jobs are the benchmark's own
    loop, which no span of the program can cover, and are left out."""
    covered = _merged((o.start, o.end) for o in spans(trace))
    if not trace.device_ops or not trace.n_jobs or not covered:
        return None
    w0, w1 = trace.window
    gaps, t = [], w0
    for s, e in trace.busy_intervals(trace.devices()[0]):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    gaps = _clipped(gaps, _merged(trace.jobs))
    idle = sum(e - s for s, e in gaps)
    inside = sum(e - s for s, e in _clipped(gaps, covered))
    return idle, idle - inside


def _clipped(intervals, keep) -> List[Tuple[float, float]]:
    """The parts of the sorted, disjoint ``intervals`` that lie inside the
    sorted, disjoint ``keep``."""
    out: List[Tuple[float, float]] = []
    k = 0
    for s, e in intervals:
        while k < len(keep) and keep[k][1] <= s:
            k += 1
        j = k
        while j < len(keep) and keep[j][0] < e:
            out.append((max(s, keep[j][0]), min(e, keep[j][1])))
            j += 1
    return out


def marks(trace, layer: str) -> List[Dict[str, int]]:
    """The values of every ``psa.count <layer> ...`` mark in the window."""
    head = f"{COUNT} {layer} "
    out = []
    for o in trace.host_ops:
        if o.cat == ANNOTATION and o.name.startswith(head):
            out.append({k: int(v) for k, v in
                        (kv.split("=", 1) for kv in o.name[len(head):].split())})
    return out
