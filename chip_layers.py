#!/usr/bin/env python3
"""Time the layers of the port's gain-spectrum path on one CUDA card.

Run from the root of a checkout:

    python3 chip_layers.py [--root DIR] [--reps 20] [--out FILE]

``--root DIR`` imports the package from another checkout (its kernels are
built under ``DIR/build/``), so two trees can be timed in turns in one run.
The configuration is ``chip_smoke.py``'s: the bench job of
``bench.py:190-220``, 2,500 RK4 steps per point, ``save_every=10``.

What it prints, each figure the median of ``--reps`` warm reps:

- parameter math (dispersion, frequency plan, dbeta on the card), 10^4
  points: host clock around a synchronized call;
- ``solve_batch_cuda`` at fp64 and fp32, 10^4 points, and at fp64, 250k
  points: CUDA events around each call;
- ``gain_spectrum`` end to end at df32 and x32, 10^4 points: host clock
  around a synchronized call;
- under ``torch.profiler`` over 5 df32 calls: the kernel's self time per
  call, the device's busy time per call, and the idle share of the wall
  time (profiler on); beside it the idle share against the unprofiled
  end-to-end time;
- the kernels' registers and spills from the build log.

The last line is a JSON object of all of these; ``--out`` also writes it to
a file.  Without a CUDA device the script exits non-zero.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import N_POINTS, N_STEADY, bench_common, cfg_for, lanes, timed


def median_event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_us(evt):
    """Self device time of a profiler key average, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler events carry no device time")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="checkout to import the package from (default: this one)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_layers: torch.cuda.is_available() is False -- this script times "
                 "the CUDA card and never runs on the CPU")
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    import psa_torch as psa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_solver as cs
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import sweep
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils.checks import as_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    out = {"root": str(Path(psa.__file__).resolve().parent), "card": card,
           "torch": torch.__version__, "reps": args.reps}
    for name in _build.build():
        _build.load_library(name)
    out["ptxas"] = [line.strip() for line in _build.build_log().splitlines()
                    if "registers" in line or "spill" in line or "Compiling entry" in line]

    common = bench_common(psa)
    lam3 = np.linspace(1540e-9, 1650e-9, N_POINTS)
    pm = common["phase_matching_cfg"]

    def param_math():
        disp_m = common["dispersion"].scaled(1.0).to(dev)
        om, _valid = sweep._batched_plan_from_wavelengths(
            common["lambda_p1_m"], common["lambda_p2_m"], as_f64(lam3, device=dev))
        return sweep._batched_delta_beta(om, disp_m, pm.scaled(1.0))

    out["param_math_ms"] = 1e3 * timed(param_math, args.reps)

    kw = dict(dz_m=0.2, n_steps=2500, save_every=10, integrator="rk4")
    for label, n, rdt in (("solve_f64_1e4_ms", N_POINTS, torch.float64),
                          ("solve_f32_1e4_ms", N_POINTS, torch.float32),
                          ("solve_f64_250k_ms", N_STEADY, torch.float64)):
        t = lanes(psa, common, n, rdt, dev)
        out[label] = median_event_ms(lambda: cs.solve_batch_cuda(*t, **kw), args.reps)

    def spectrum(precision):
        return psa.gain_spectrum(cfg=cfg_for(psa, precision), lambda_signal_m=lam3,
                                 device="cuda", **common)

    for precision in ("df32", "x32"):
        out[f"e2e_{precision}_ms"] = 1e3 * timed(lambda: spectrum(precision), args.reps)

    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    spectrum("df32")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            spectrum("df32")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    busy_ms = sum(device_us(e) for e in avgs) / 1e3
    kernel_ms = sum(device_us(e) for e in avgs if "fwm4_rk_kernel" in e.key) / 1e3
    if busy_ms <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    out.update(
        prof_kernel_ms_per_call=kernel_ms / n_prof,
        prof_busy_ms_per_call=busy_ms / n_prof,
        prof_wall_ms_per_call=wall_ms / n_prof,
        idle_share_profiler_on=1.0 - busy_ms / wall_ms,
        idle_share_vs_unprofiled_e2e=1.0 - (busy_ms / n_prof) / out["e2e_df32_ms"],
    )

    for k, v in out.items():
        if k != "ptxas":
            print(f"{k}: {v}", flush=True)
    for line in out["ptxas"]:
        print(f"  ptxas: {line}")
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
