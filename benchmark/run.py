"""Run one cell of the port's benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port
(``psa_simulation_ode_rk_mvp_dispersion_tpu_torch``).  Everything is found by
name from ``BENCHMARK.json``:

- the cell (``workloads``) names a configuration and a traffic mix;
- the configuration's file (``benchmark/configs/<config>.json``) holds its
  physics, and ``benchmark/configs/<config>.py`` its driver, whose
  ``build(config, traffic, seed, env)`` makes the inputs from the seed and
  returns an object with ``instances_per_job``, ``job(k)``, ``keep(k,
  answer)``, ``failed(answer)``, ``release()`` and ``check(device)``;
- the traffic mix is ``benchmark/traffic/<traffic>.json``;
- each per-layer metric is read by ``benchmark/metrics/<metric>.py``'s
  ``read(trace)``, which returns None where it finds nothing to read.

A run: set-up (the port's import, its kernels' build on the first run in a
checkout, the cell's inputs, two warm jobs), then a closed loop of one
client for ``--seconds``, each job waiting for its host result, then the
check of every job's sampled answers against the plain reference.  With
``--trace 1`` the loop runs under the profiler and the line carries the
per-layer metrics instead of the end-to-end ones.  ``--precision`` runs
the cell at another precision of the program (the control: ``x32`` must
come out not correct); the benchmark's own runs leave it out.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run (compared whole:
# the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "psa_simulation_ode_rk_mvp_dispersion_tpu")
# jobs run at set-up before the window, on the cell's own shapes
WARMUP_JOBS = 2


class NoCard(RuntimeError):
    """The run needs more CUDA cards than this process has."""


def load_manifest(root: Path = CHECKOUT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(manifest: dict, workload: str, bench_dir: Path = BENCH_DIR,
              root: Path = CHECKOUT):
    """``(workload entry, config dict, driver module, traffic dict)`` of the
    cell named ``workload``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    driver = _module(bench_dir / "configs" / f"{cell['config']}.py",
                     f"benchmark_config_{cell['config']}")
    with open(bench_dir / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, driver, traffic


def per_layer_metrics(manifest: dict, workload: str, bench_dir: Path = BENCH_DIR):
    """``{name: (entry, reader module)}`` of the per-layer metrics this cell
    reports: those that list it, and those that list no cells."""
    out = {}
    for m in manifest["per_layer"]:
        if workload in m.get("workloads", [workload]):
            out[m["name"]] = (m, _module(bench_dir / "metrics" / f"{m['name']}.py",
                                         f"benchmark_metric_{m['name'].replace('.', '_')}"))
    return out


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _devices(torch, chips: int, device):
    if device is not None:
        return [torch.device(device)]
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark measures the CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA card(s); this process has "
                     f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(chips)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, precision=None,
             device=None, overrides=None, t_start: float = T_START,
             bench_dir: Path = BENCH_DIR, root: Path = CHECKOUT):
    """Run the cell and return ``(result line dict, checks, stderr lines)``.

    ``device`` (``'cpu'`` in the tests) skips the look for cards and runs
    the port's plain versions there; ``overrides`` updates the traffic (and
    its ``physics`` key the configuration's physics) for a test at a size
    the CPU holds."""
    import torch

    manifest = load_manifest(root)
    cell, config, driver, traffic = load_cell(manifest, workload, bench_dir, root)
    for key, value in (overrides or {}).items():
        if key == "physics":
            config = dict(config, physics=dict(config["physics"], **value))
        else:
            traffic = dict(traffic, **{key: value})
    if precision is not None:
        traffic = dict(traffic, precision=precision)
    chips = int(cell["chips"])
    devs = _devices(torch, chips, device)
    on_card = devs[0].type == "cuda"
    readers = per_layer_metrics(manifest, workload, bench_dir) if trace else {}
    env = SimpleNamespace(device=devs[0], chips=chips)
    t_build = time.perf_counter()
    bench = driver.build(config, traffic, int(seed), env)
    t_warm = time.perf_counter()
    warm = []
    for k in range(WARMUP_JOBS):
        bench.job(k)
        warm.append(time.perf_counter())
    if on_card:
        for d in devs:
            torch.cuda.synchronize(d)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    def span(name):
        return torch.profiler.record_function(name) if trace else contextlib.nullcontext()

    times, failed, errors = [], 0, []
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with span("bench.window"):
        k = 0
        while True:
            a = time.perf_counter()
            with span("bench.job"):
                try:
                    answer = bench.job(k)
                except Exception:   # a failed job counts; the loop goes on
                    answer = None
                    errors.append(traceback.format_exc(limit=4))
            b = time.perf_counter()
            times.append(b - a)
            if answer is None:
                failed += bench.instances_per_job
            else:
                failed += bench.failed(answer)
                bench.keep(k, answer)
            k += 1
            if b - t0 >= seconds:
                break
    t_last = b
    n_jobs = k
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devs) if on_card else 0

    trace_data = None
    if prof is not None:
        prof.stop()
        from . import trace as tr
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            events = tr.load(path)
        trace_data = tr.Trace(events, tr.Cell(workload, config, traffic,
                                              bench.instances_per_job, chips))
        del events

    bench.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = bench.check(devs[0])
    correct = not errors and all(c.passed for c in checks.values())

    if trace_data is None:
        metrics = {
            "instances_per_s": {"value": n_jobs * bench.instances_per_job / (t_last - t0),
                                "unit": "instances/s"},
            "job_p95_ms": {"value": 1e3 * p95(times), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        metrics = {}
        for name, (entry, reader) in readers.items():
            value = reader.read(trace_data)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": entry["unit"]}
    dev_info = {"platform": "gpu" if on_card else devs[0].type,
                "kind": torch.cuda.get_device_name(devs[0]) if on_card else devs[0].type,
                "count": len(devs) if on_card else 0,
                "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": n_jobs * bench.instances_per_job,
            "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace_data is not None:
        dev_info["busy_s"] = trace_data.busy_s()
        dev_info["window_s"] = trace_data.window_s
        line["breakdown"] = {"device_ops": trace_data.top_device_ops(),
                             "idle_gaps": trace_data.idle_gaps()}
    line["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in checks.items()}
    from .reference.compare import render
    q = statistics.quantiles(times, n=20, method="inclusive") if len(times) > 1 else times * 19
    notes = [f"set-up {setup_s:.3f} s: process and imports {t_build - t_start:.3f}, inputs "
             f"{t_warm - t_build:.3f}, warm jobs "
             f"{', '.join(f'{b - a:.3f}' for a, b in zip([t_warm] + warm, warm))}, then "
             f"{t0 - (warm[-1] if warm else t_warm):.3f}",
             f"jobs {n_jobs}, job errors {len(errors)}; job ms min {1e3 * min(times):.3f} "
             f"p05 {1e3 * q[0]:.3f} median {1e3 * q[9]:.3f} p95 {1e3 * q[18]:.3f} "
             f"max {1e3 * max(times):.3f}; the process's CPU in the window "
             f"{ru1.ru_utime - ru0.ru_utime:.2f} s user, {ru1.ru_stime - ru0.ru_stime:.2f} s "
             f"system"] + errors[:2] + render(checks)
    return line, checks, notes


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n", 1)[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", default=None,
                    help="run the program at this precision (the control: x32)")
    args = ap.parse_args(argv)
    # the program's caches inside the checkout, at fixed paths: the CUDA
    # driver's, and Python's bytecode, which the first run writes.  Where
    # PYTHONDONTWRITEBYTECODE is set and the installed packages carry no
    # bytecode, every run would otherwise compile torch's sources anew (~7 s
    # of set-up on an H100 host, that host's load in its spread).
    os.environ.setdefault("CUDA_CACHE_PATH", str(CHECKOUT / "build" / "cuda_cache"))
    sys.pycache_prefix = str(CHECKOUT / "build" / "pycache")
    sys.dont_write_bytecode = False
    try:
        line, _checks, notes = run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), precision=args.precision)
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; the port's benchmark runs "
              "without JAX and without the JAX package", file=sys.stderr)
        return 3
    for n in notes:
        print(n, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
