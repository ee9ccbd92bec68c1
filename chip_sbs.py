#!/usr/bin/env python3
"""Time the port's FWM + SBS relaxation (``models/sbs.py``) on one CUDA card.

Run from the root of a checkout:

    python3 chip_sbs.py [--skip-cli]

The relaxation has no kernel in either package: each sweep is a loop of
RK4 steps of plain torch on a ``(B, 2, 2)`` complex state, one step about
50 launches, so its time is the launches' (the host issuing them), not the
card's work.  What it prints, on the card named beside each number with its
power limit (``nvidia-smi``):

- 3 sweeps at the command line's default length (200 m in steps of
  0.02 m, 10^4 steps): wall seconds a sweep and microseconds a step, after
  one warm sweep, host clock with synchronize;
- under ``torch.profiler``, one sweep of 100 steps: the launches and the
  device's busy time against the wall time (the idle share);
- unless ``--skip-cli``: ``python -m
  psa_simulation_ode_rk_mvp_dispersion_tpu_torch --no-show sbs`` at its
  defaults (200 m, ``g_B`` 150 /(W km), at most 200 sweeps, tol 1e-10) in a
  process of its own, once: wall seconds, the sweeps it ran and their
  residual, and the files it wrote.

The last line is a JSON object of these numbers.  Without a CUDA device the
script exits non-zero.
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = "psa_simulation_ode_rk_mvp_dispersion_tpu_torch"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-cli", action="store_true",
                    help="leave out the command line's run at its defaults (minutes)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_sbs: no CUDA device -- this measurement needs the card")
    sys.path.insert(0, str(ROOT))
    import psa_torch as psa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card}
    # the command line's physics (experiments/sbs.py defaults)
    kw = dict(gamma=11.5e-3, alpha=0.5 * np.log(10.0) / 10.0 / 1000.0, g_B=0.15, delta_beta=0.0,
              p_in=[0.5, 0.5, 1e-5, 0.0], p_stokes_seed=[1e-6, 1e-6, 0.0, 0.0],
              length_unit="m", device="cuda")
    cfg = psa.custom_simulation_config(z_max=200.0, dz=0.02, save_every=50)
    psa.run_sbs_simulation(cfg, n_iterations=1, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psa.run_sbs_simulation(cfg, n_iterations=3, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out["sweep_s"] = sec / 3
    out["step_us"] = 1e6 * sec / (3 * 10_000)
    print(f"3 sweeps of 10,000 steps (200 m, the CLI default): {sec:.3f} s = "
          f"{out['sweep_s']:.3f} s a sweep = {out['step_us']:.1f} us a step on {card}", flush=True)

    short = psa.custom_simulation_config(z_max=2.0, dz=0.02, save_every=50)
    psa.run_sbs_simulation(short, n_iterations=1, **kw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        psa.run_sbs_simulation(short, n_iterations=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
                  for e in kernels)
    out["profile"] = {"steps": 100, "launches": len(kernels), "device_busy_ms": busy_us / 1e3,
                      "wall_ms": wall * 1e3, "idle_share": 1.0 - busy_us / 1e6 / wall}
    print(f"profiler, one sweep of 100 steps: {len(kernels)} kernels ({len(kernels) / 100:.1f} a "
          f"step), device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall: idle share "
          f"{out['profile']['idle_share']:.4f} (profiler on) on {card}", flush=True)

    if not args.skip_cli:
        save = Path(tempfile.mkdtemp(prefix="psa_sbs_"))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", PKG, "--no-show", "--save-dir", str(save), "sbs"],
                           capture_output=True, text=True, cwd=str(ROOT))
        sec = time.perf_counter() - t0
        m = re.search(r"residual (\S+) after (\d+) sweeps", p.stdout)
        out["cli"] = {"exit": p.returncode, "wall_s": sec,
                      "sweeps": int(m.group(2)) if m else None,
                      "residual": float(m.group(1)) if m else None,
                      "files": sorted(f.name for f in save.iterdir())}
        print(f"python -m {PKG} --no-show sbs (defaults): exit {p.returncode}, {sec:.1f} s wall, "
              f"{out['cli']['sweeps']} sweeps, residual {out['cli']['residual']} on {card}; "
              f"files {out['cli']['files']}", flush=True)
        print(p.stdout[-1500:], p.stderr[-1500:], flush=True)
        if p.returncode != 0:
            sys.exit(f"chip_sbs: the command line failed with exit {p.returncode}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
