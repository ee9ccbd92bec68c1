#!/usr/bin/env python3
"""A/B of K1t (``csrc/fwm4_tangent.cu``) between two checkouts on one CUDA
card: its time from ``fit-gain``'s width to 10^4 lanes and one adam step of
a fit end to end.

Run from the root of a checkout, with another checkout (say the parent
commit's, unpacked by ``git archive``) as the first argument:

    python3 chip_tangent_ab.py PARENT_DIR [CHANGE_DIR] [--rounds 2]

``CHANGE_DIR`` is this checkout unless given.  The two sides run in turns,
parent, change, change, parent (``--rounds`` pairs), each in a process of
its own that imports its tree's package and builds only its tree's
``fwm4_tangent.cu`` (with that tree's flags, ``ops/_build.py``) into a
temporary directory of the tree's own, removed at the end.  The inputs, the
timer and the fit come from this checkout's ``chip_smoke.py`` (phase 29's
``tangent_lanes``, ``timed`` and ``fit_gain_seconds``).  Each process reads:

- K1t through ``ops/cuda_tangent.solve_tangent_cuda`` (the design the
  tree's launcher takes by width) at ``chip_smoke.TANGENT_WIDTHS`` x 500
  steps of 1 m, fp64 and fp32, median of 5 warm reps, host clock with
  synchronize; where the tree has ``solve_tangent_design``, its
  one-thread design (``g1``) too;
- one adam step of ``parallel/calibrate.fit_gain_curve`` at ``fit-gain``'s
  width (200 points of delta beta over +-40 1/km; a 60-step fit less a
  10-step one, over 50; median of 3), on a curve that the tree's own gain
  model makes at gamma 10 1/(W km);
- a 50-step fit of the same under ``torch.profiler``: its wall time, the
  device's busy time (all kernels, and K1t's), its launches, the host's
  time in the calls that wait for the card, and the device's idle share;
- where the tree has ``solve_tangent_design``, the adam step and the
  profiled fit's wall time a step again with the kernel's design pinned
  to a group of 4 and to one thread, in turns (4, 1, 1, 4), in the same
  process (``by_design``).

It prints each process's readings as they come and, as the last line, a
JSON object of all of them with their medians by side and the card's name
and power limit.  Without a CUDA device the script exits non-zero.
"""

import argparse
import functools
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
PROFILE_STEPS = 50
# the host calls that wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def worker(tree: Path, build: Path) -> dict:
    """The readings of ``tree``'s package, in this process, its kernel
    built in ``build``."""
    sys.path[0] = str(tree)
    import numpy as np
    import torch

    import psa_torch as psa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_tangent as ct
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import calibrate as C

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    csrc = build / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for f in [*_build.CSRC_DIR.glob("*.cuh"), _build.CSRC_DIR / "fwm4_tangent.cu"]:
        (csrc / f.name).write_bytes(f.read_bytes())
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, build / "lib"
    _build.build.cache_clear()
    _build.load_library("fwm4_tangent")
    dev = torch.device("cuda")

    out = {"tree": str(tree), "k1t_ms": {}}
    for B, D in cs.TANGENT_WIDTHS:
        for rdt in (torch.float64, torch.float32):
            args = [x.to(rdt).contiguous() for x in cs.tangent_lanes(rdt, dev, D == 8, B)]
            key = f"{B}x{D} {cs.suffix(rdt)}"
            out["k1t_ms"][key] = 1e3 * cs.timed(lambda: ct.solve_tangent_cuda(
                *args, dz_m=cs.FIT_DZ, n_steps=cs.FIT_STEPS))
            if hasattr(ct, "solve_tangent_design"):
                out["k1t_ms"][key + " g1"] = 1e3 * cs.timed(lambda: ct.solve_tangent_design(
                    *args, dz_m=cs.FIT_DZ, n_steps=cs.FIT_STEPS, group=1))
    db = np.linspace(-0.04, 0.04, cs.FIT_B)
    cfg = psa.custom_simulation_config(z_max=cs.FIT_STEPS * cs.FIT_DZ, dz=cs.FIT_DZ)
    with torch.no_grad():
        curve = C.make_gain_model(cfg, p_in=[0.1, 0.1, 1e-5, 0.0], device=dev)(psa.RHSCoeffs(
            0.01, 0.0, torch.tensor(db))).double().cpu().numpy()

    def fit(steps):
        return cs.fit_gain_seconds(psa, C, db, curve, dev, steps)

    def step_ms():
        return 1e3 * (fit(60) - fit(10)) / 50

    fit(10)
    out["adam_step_ms"] = statistics.median(step_ms() for _ in range(3))
    out["profile"] = profile(fit, PROFILE_STEPS)
    if hasattr(ct, "solve_tangent_design"):
        # the same fit with the kernel's design pinned, in turns, in this
        # process: whether the step follows the design or the tree
        by_width = ct.solve_tangent_cuda
        steps, walls = {1: [], 4: []}, {1: [], 4: []}
        try:
            for g in (4, 1, 1, 4):
                ct.solve_tangent_cuda = functools.partial(ct.solve_tangent_design, group=g)
                steps[g].append(step_ms())
                walls[g].append(profile(fit, PROFILE_STEPS)["per_step_ms"]["wall"])
        finally:
            ct.solve_tangent_cuda = by_width
        out["by_design"] = {f"g{g}": {"adam_step_ms": steps[g], "profiled_wall_ms": walls[g]}
                            for g in (1, 4)}
    return out


def profile(fit, steps):
    """A ``steps``-step fit under ``torch.profiler``: its wall time, the
    device's busy time (every kernel, and K1t's), its launches, the host's
    time in synchronizing calls (waiting for the card) and the idle share,
    in ms and ms a step (profiler on)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = fit(steps)
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]

    def device_us(e):
        return e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total

    busy = sum(device_us(e) for e in kernels) / 1e3
    k1t = sum(device_us(e) for e in kernels if "fwm4_tangent" in e.name) / 1e3
    wait = sum(e.self_cpu_time_total for e in events if e.name in SYNC_CALLS) / 1e3
    return {"steps": steps, "wall_ms": 1e3 * wall, "kernels": len(kernels),
            "device_busy_ms": busy, "k1t_ms": k1t, "host_wait_ms": wait,
            "idle_share": 1.0 - busy / (1e3 * wall),
            "per_step_ms": {"wall": 1e3 * wall / steps, "device_busy": busy / steps,
                            "k1t": k1t / steps, "host_wait": wait / steps}}


def medians(runs):
    """Each reading's median over ``runs``."""
    out = {"adam_step_ms": statistics.median(r["adam_step_ms"] for r in runs),
           "k1t_ms": {k: statistics.median(r["k1t_ms"][k] for r in runs)
                      for k in runs[0]["k1t_ms"]}}
    out["profile_per_step_ms"] = {k: statistics.median(r["profile"]["per_step_ms"][k]
                                                       for r in runs)
                                  for k in runs[0]["profile"]["per_step_ms"]}
    out["idle_share"] = statistics.median(r["profile"]["idle_share"] for r in runs)
    if "by_design" in runs[0]:
        out["by_design"] = {g: {k: statistics.median(v for r in runs
                                                     for v in r["by_design"][g][k])
                                for k in runs[0]["by_design"][g]}
                            for g in runs[0]["by_design"]}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=HERE)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.parent.resolve(), args.worker)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_tangent_ab: no CUDA device; this A/B runs only on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    runs = []
    with tempfile.TemporaryDirectory(prefix="k1t_ab_") as tmp:
        for _ in range(args.rounds):
            for side in ("parent", "change", "change", "parent"):
                proc = subprocess.run([sys.executable, str(HERE / "chip_tangent_ab.py"),
                                       str(trees[side]), "--worker", str(Path(tmp) / side)],
                                      capture_output=True, text=True, cwd=str(trees[side]))
                if proc.returncode != 0:
                    sys.exit(f"chip_tangent_ab: the {side} worker failed:\n{proc.stderr[-4000:]}")
                reading = json.loads(proc.stdout.strip().splitlines()[-1]) | {"side": side}
                print(json.dumps(reading), flush=True)
                runs.append(reading)
    summary = {side: medians([r for r in runs if r["side"] == side]) for side in trees}
    print(json.dumps({"card": card, "runs": runs, "median": summary}))


if __name__ == "__main__":
    main()
