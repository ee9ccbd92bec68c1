#!/usr/bin/env python3
"""Time K3 (``csrc/fwm4_rk45.cu``) with a lane on 4 threads and on one,
across batch sizes, on one CUDA card: the two instantiations its launcher
picks between.

Run from the root of a checkout:

    python3 chip_fwm4_groups.py [--reps 5] [--out FILE]

K3's launcher takes 4 threads a lane below 256 lanes an SM and one from
there.  This script builds the source twice into ``build/fwm4_groups/``,
with the launcher's pick replaced by one G (a copy of the source, edited as
text; the package's flags), and runs each build through the package's
wrapper on ``chip_smoke.py``'s inputs: the bench configuration over 10^4 to
250,000 wavelengths of its band (``BATCHES``), 2,500 steps of 0.2 m at
``save_every=10``, in fp64 (rtol 1e-10, atol 1e-13) and fp32 (1e-6,
1e-10).  Each time is the median of ``--reps`` warm calls (host clock with
synchronize, ``chip_smoke.timed``), the builds taken in turns 4, 1, 1, 4.
Beside the times: the attempts a lane (mean, max) and the tail lane's time
an attempt, each build's registers and spills (``-Xptxas -v``), and whether
the G = 1 build's counters and outputs agree with the G = 4 build's on
every lane.

The last line is a JSON object of all of these; ``--out`` also writes it to
a file.  Without a CUDA device it exits non-zero.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import N_POINTS, N_STEADY, RK45_TOL, bench_common, lanes, rel_err, suffix, timed

GROUPS = (4, 1)
# Each build: the source with the launcher's pick replaced by one G.
BUILDS = {G: ("group_size(B) == 1", "true" if G == 1 else "false") for G in GROUPS}
# the main path's 10^4 lanes, the 250,000-lane case, and batches between
BATCHES = (N_POINTS, 25_000, 50_000, 100_000, N_STEADY)


def build_groups(_build):
    """Compile the builds of ``BUILDS`` side by side; return ({G: library
    path}, {G: ptxas lines})."""
    out_dir = _build.BUILD_DIR.parent / "fwm4_groups"
    out_dir.mkdir(parents=True, exist_ok=True)
    src_path = _build.CSRC_DIR / "fwm4_rk45.cu"
    procs = {}
    for G, (old, new) in BUILDS.items():
        text = src_path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"fwm4_rk45.cu: {old!r} is not where this script expects it")
        src = out_dir / f"fwm4_rk45_G{G}.cu"
        src.write_text(text.replace(old, new))
        lib = out_dir / f"libfwm4_rk45_G{G}.so"
        procs[G] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build._flags(src_path), f"-I{_build.CSRC_DIR}", "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs, ptxas = {}, {}
    for G, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for G = {G}:\n{out}{err}")
        libs[G] = lib
        ptxas[G] = [line.strip() for line in (out + err).splitlines()
                    if "registers" in line or "spill" in line]
    return libs, ptxas


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_fwm4_groups: torch.cuda.is_available() is False -- this script times "
                 "the CUDA card and never runs on the CPU")
    import psa_torch as psa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive as ca

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs, ptxas = build_groups(_build)
    loaded = {G: ctypes.CDLL(str(path)) for G, path in libs.items()}
    package_load = _build.load_library

    def solve(G, fn):
        """fn() through the package's wrapper, launching that build."""
        _build.load_library = lambda name: loaded[G]
        try:
            return fn()
        finally:
            _build.load_library = package_load

    common = bench_common(psa)
    dev = torch.device("cuda")
    kw = dict(dz_m=0.2, n_steps=2500, save_every=10)
    out = {"card": card, "torch": torch.__version__, "reps": args.reps,
           "ptxas": {str(G): lines for G, lines in ptxas.items()}, "cases": {}}
    for rdt in (torch.float64, torch.float32):
        rtol, atol = RK45_TOL[rdt]
        for B in BATCHES:
            t = lanes(psa, common, B, rdt, dev)
            fn = (lambda t=t, rtol=rtol, atol=atol: ca.solve_batch_rk45_cuda(
                *t, **kw, rtol=rtol, atol=atol))
            label = f"K3 {suffix(rdt)} {B}"
            res = {G: solve(G, fn) for G in GROUPS}
            torch.cuda.synchronize()
            ms = {G: [] for G in GROUPS}
            for G in GROUPS + GROUPS[::-1]:
                ms[G].append(1e3 * timed(lambda: solve(G, fn), reps=args.reps))
            ref = res[4]
            att = (ref.n_accepted + ref.n_rejected).double()
            case = {"ms": {str(G): v for G, v in ms.items()},
                    "ms_mean": {str(G): float(np.mean(v)) for G, v in ms.items()},
                    "attempts_mean": float(att.mean()), "attempts_max": int(att.max()),
                    "tail_us_per_attempt": {str(G): 1e3 * float(np.mean(v)) / int(att.max())
                                            for G, v in ms.items()},
                    "counters_equal_to_G4": bool(torch.equal(res[1].n_accepted, ref.n_accepted)
                                                 and torch.equal(res[1].n_rejected,
                                                                 ref.n_rejected)),
                    "bitwise_to_G4": bool(torch.equal(res[1].P_max, ref.P_max)
                                          and torch.equal(res[1].A_end, ref.A_end)),
                    "max_rel_to_G4": float(rel_err(res[1].A_end, ref.A_end).max())}
            out["cases"][label] = case
            print(f"{label}: " + ", ".join(f"G={G} {case['ms_mean'][str(G)]:.3f} ms"
                                           for G in GROUPS) + f"; {json.dumps(case)}",
                  flush=True)
    for key, lines in out["ptxas"].items():
        for line in lines:
            print(f"  ptxas {key}: {line}")
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
