"""Tracing, profiling, and throughput instrumentation.

Counterpart of the JAX package's ``utils/observability.py``.  The
reference's only observability is manual wall-clock prints inside one sweep
(``scan_mismtach.py:112, :162-180``: elapsed total / avg per point /
throughput) plus tqdm bars.  Here:

- :func:`profile_trace`: context manager around ``torch.profiler`` writing a
  Chrome/Perfetto trace of the host and, when a CUDA card is present, of the
  device's kernels.
- :class:`ThroughputMeter`: the reference's elapsed/avg/points-per-second
  instrumentation as a reusable object (sweeps return these numbers in their
  results; this class serves custom loops).
- :func:`log_run`: one-line structured (JSON) run records appended to a file
  -- greppable run history with device/config provenance.

Progress bars: deliberately NOT inside hot loops.  A batched sweep is one
kernel launch; per-point host callbacks would serialize it.  For multi-batch
campaigns, wrap the outer Python loop in :class:`ThroughputMeter`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a profile around a block:

        with profile_trace("/tmp/psa_trace"):
            sweeps.gain_spectrum(...)

    Records the host's operators and, when ``torch.cuda.is_available()``,
    the CUDA kernels and copies; on leaving the block (also on an error)
    writes ``psa_torch_trace_<pid>_<ns>.json`` under ``log_dir``, a Chrome
    trace that ``chrome://tracing``, Perfetto and TensorBoard read.

    ``create_perfetto_link``: the JAX package's profiler serves its trace
    to the Perfetto UI and prints a link.  Here nothing is served: when True
    the path of the written trace is printed, to be opened in the Perfetto
    UI (ui.perfetto.dev) by hand.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir).expanduser()
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = out / f"psa_torch_trace_{os.getpid()}_{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        if create_perfetto_link:
            print(f"trace written to {path}: open it in the Perfetto UI (ui.perfetto.dev)")


@dataclass
class ThroughputMeter:
    """Elapsed / average / throughput bookkeeping (reference
    scan_mismtach.py:162-180 parity, reusable)."""

    label: str = "run"
    _t0: float = field(default_factory=time.perf_counter)
    _count: int = 0

    def tick(self, n: int = 1) -> None:
        self._count += n

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def count(self) -> int:
        return self._count

    @property
    def per_second(self) -> float:
        el = self.elapsed_s
        return self._count / el if el > 0 else float("inf")

    @property
    def avg_s(self) -> float:
        return self.elapsed_s / self._count if self._count else float("nan")

    def summary(self) -> str:
        return (
            f"[{self.label}] Elapsed total: {self.elapsed_s:.3f} s | "
            f"Avg per item: {self.avg_s:.4f} s | "
            f"Throughput: {self.per_second:.2f} items/s"
        )

    def report(self) -> None:
        print(self.summary())


def log_run(
    path,
    record: Dict[str, Any],
    *,
    include_device_info: bool = True,
) -> Path:
    """Append one JSON line describing a run to ``path`` (greppable history);
    ``backend`` names the torch device kind (``cuda`` or ``cpu``)."""
    from ..io_fwm import make_run_metadata

    md = make_run_metadata(record, include_device_info=include_device_info)
    p = Path(path).expanduser()
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a", encoding="utf-8") as f:
        f.write(json.dumps(md, default=str) + "\n")
    return p
