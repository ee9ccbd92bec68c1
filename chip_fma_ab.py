#!/usr/bin/env python3
"""A/B of the rk45 kernel (``csrc/fwm4_rk45.cu``) built with and without FMA
contraction, on one CUDA card.

Run from the root of a checkout:

    python3 chip_fma_ab.py [--reps 5] [--out FILE]

The package builds ``fwm4_rk45.cu`` with FMA contraction (``ops/_build.
NVCC_FLAGS``): its float32 instantiation keeps every product apart in the
source (``__fmul_rn``), so that it rounds as its plain version does and the
two take the same adaptive steps, and its float64 instantiation contracts.
This script builds the source twice into ``build/fma_ab/``, once with
``-fmad=false`` added (``nofma``: no contraction in either type) and once
with the package's flags (``fma``), and runs both through the package's
wrapper on
``chip_smoke.py``'s inputs: the bench configuration's 10^4 lanes with one
lane made to blow up, fp64 at rtol 1e-10/atol 1e-13 and fp32 at rtol
1e-6/atol 1e-10, 2,500 steps at ``save_every=10``, and the fp32 cases with a
trailing span (2,497 steps) and with ``save_every=7``.

For each case it prints the share of lanes whose step counters agree between
the two builds, whether ``ok`` agrees, and the largest relative difference in
``P_max``/``A_end``; in float32 the two builds must agree bit for bit.
``chip_smoke.py`` phase 4 holds the package's (``fma``) build against the
plain version.  Times: CUDA
events, median of ``--reps`` warm reps, in the order nofma, fma, fma, nofma;
registers and spills come from each build's ``-Xptxas -v`` output.

The last line is a JSON object of all of these.  Without a CUDA device the
script exits non-zero.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import N_POINTS, RK45_TOL, bench_common, lanes, rel_err, with_bad_lane

CASES = ((torch.float64, 2500, 10), (torch.float32, 2500, 10), (torch.float32, 2497, 10),
         (torch.float32, 2500, 7))


def build_variants(_build):
    """Compile fwm4_rk45.cu with -fmad=false added and with the package's
    flags, side by side; return ({variant: library path}, {variant: ptxas
    lines})."""
    src = _build.CSRC_DIR / "fwm4_rk45.cu"
    out_dir = _build.BUILD_DIR.parent / "fma_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = {"nofma": _build._flags(src) + ("-fmad=false",), "fma": _build._flags(src)}
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *f, "-o", str(out_dir / f"libfwm4_rk45_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name, f in flags.items()}
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{out}{err}")
        libs[name] = out_dir / f"libfwm4_rk45_{name}.so"
        ptxas[name] = [line.strip() for line in (out + err).splitlines()
                       if "registers" in line or "spill" in line]
    return libs, ptxas


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_fma_ab: torch.cuda.is_available() is False -- this script times "
                 "the CUDA card and never runs on the CPU")
    import psa_torch as psa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive as ca

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs, ptxas = build_variants(_build)
    loaded = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
    package_launcher = ca._launcher

    def solve(variant, t, kw):
        """The package's wrapper, launching the given build's kernel."""
        def launcher(rdt):
            fn = getattr(loaded[variant], f"fwm4_rk45_{'f64' if rdt == torch.float64 else 'f32'}")
            fn.argtypes = package_launcher(rdt).argtypes
            fn.restype = ctypes.c_int
            return fn
        ca._launcher = launcher
        try:
            return ca.solve_batch_rk45_cuda(*t, **kw)
        finally:
            ca._launcher = package_launcher

    common = bench_common(psa)
    dev = torch.device("cuda")
    out = {"card": card, "torch": torch.__version__, "reps": args.reps, "ptxas": ptxas,
           "cases": []}
    for rdt, n_steps, save_every in CASES:
        rtol, atol = RK45_TOL[rdt]
        t = with_bad_lane(lanes(psa, common, N_POINTS, rdt, dev), N_POINTS // 2)
        kw = dict(dz_m=0.2, n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol)
        r = {name: solve(name, t, kw) for name in ("nofma", "fma")}
        torch.cuda.synchronize()
        a, b = r["nofma"], r["fma"]
        same = (a.n_accepted == b.n_accepted) & (a.n_rejected == b.n_rejected)
        case = dict(
            dtype=str(rdt)[6:], n_steps=n_steps, save_every=save_every, lanes=N_POINTS,
            counters_agree_share=float(same.double().mean()),
            ok_equal=bool(torch.equal(a.ok, b.ok)),
            bitwise=all(bool(torch.equal(getattr(a, f), getattr(b, f)))
                        for f in ("P_max", "A_end", "ok", "n_accepted", "n_rejected")),
            max_rel_P_max=float(rel_err(b.P_max, a.P_max).max()),
            max_rel_A_end=float(rel_err(b.A_end, a.A_end).max()),
            max_rel_P_max_equal_counters=float(rel_err(b.P_max, a.P_max)[same].max()),
            attempts_mean={k: float((v.n_accepted + v.n_rejected).double().mean())
                           for k, v in r.items()},
            attempts_max={k: int((v.n_accepted + v.n_rejected).max()) for k, v in r.items()},
        )
        if n_steps == 2500 and save_every == 10:
            ms = {"nofma": [], "fma": []}
            for name in ("nofma", "fma", "fma", "nofma"):
                ms[name].append(median_event_ms(lambda: solve(name, t, kw), args.reps))
            case["ms"] = ms
        out["cases"].append(case)
        print(json.dumps(case), flush=True)
    for name, lines in ptxas.items():
        for line in lines:
            print(f"  ptxas {name}: {line}")
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
