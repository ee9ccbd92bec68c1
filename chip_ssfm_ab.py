#!/usr/bin/env python3
"""Time the split-step kernels of one checkout on one CUDA card, so that two
trees can be compared in one call.

Run from the root of a checkout:

    python3 chip_ssfm_ab.py [--root DIR] [--reps 5] [--out FILE]

``--root DIR`` imports the package from another checkout (its kernels are
built under ``DIR/build/``).  Run it in turns, for example parent, change,
change, parent, in one command on one card, and compare the medians.

At ``chip_smoke.py``'s sizes, each figure the median of ``--reps`` warm
calls of the kernel's wrapper (host clock with synchronize, ``chip_smoke.
timed``):

- K6 (``csrc/gnlse_ssfm.cu``), 2,048 envelopes of 1,024 samples, 1,000
  steps: Kerr; nl with Raman (f_R = 0.18) and self-steepening; nl with
  steepening only (f_R = 0) and with Raman only (no steepening), whose
  differences from the full nl time are the Raman pairs' and the
  steepening pairs' share; fp64 and fp32;
- K7 (the affine instantiation), 4,096 cavities of 256 samples, 2,000 steps;
- K9 (``csrc/vgnlse_ssfm.cu``), 1,024 instances of 2 x 1,024 samples,
  1,000 steps: rotation (manakov), coherent (isotropic) and nl (manakov,
  Raman and steepening), fp64 and fp32;
- the kernels' registers and spills from the build log (``-Xptxas -v``).

It prints the card's name and power limit, one line a time, and as its last
line a JSON object of all of these; ``--out`` also writes it to a file.
Without a CUDA device it exits non-zero.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import (GN_OMEGA0, GN_SAVE, GN_STEPS, GN_T, GN_T0, GN_Z, LLE_DT, LLE_SAVE,
                        LLE_STEPS, VG_CASES, gnlse_lanes, lle_lanes, suffix, timed, vgnlse_lanes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="checkout to import the package from (default: this one)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_ssfm_ab: torch.cuda.is_available() is False -- this script times "
                 "the CUDA card and never runs on the CPU")
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    import psa_torch as psa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_vgnlse as cv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    root = str(Path(psa.__file__).resolve().parent)
    out = {"root": root, "card": card, "torch": torch.__version__, "reps": args.reps, "ms": {}}
    for name in ("gnlse_ssfm", "vgnlse_ssfm"):
        _build.load_library(name)
    out["ptxas"] = [line.strip() for line in _build.build_log().splitlines()
                    if "registers" in line or "spill" in line or "Compiling entry" in line]

    def record(label, fn):
        out["ms"][label] = 1e3 * timed(fn, reps=args.reps)
        print(f"{root}: {label} {out['ms'][label]:.3f} ms", flush=True)

    gn = psa.gnlse
    grid = gn.TimeGrid.for_pulse(GN_T0, n_samples=GN_T)
    gkw = dict(dz_m=GN_Z / GN_STEPS, n_steps=GN_STEPS, save_every=GN_SAVE)
    for rdt in (torch.float64, torch.float32):
        s = suffix(rdt)
        t, _ = gnlse_lanes(psa, rdt, dev)
        record(f"K6 kerr {s}", lambda: cg.solve_gnlse_batch_cuda(*t, **gkw))
        for label, f_r, w0 in (("nl", 0.18, GN_OMEGA0), ("nl f_R=0", 0.0, GN_OMEGA0),
                               ("nl no steepening", 0.18, None)):
            nl_t = gn._cast_nl(gn.make_nl_terms(grid, f_raman=f_r, omega0=w0), rdt, dev)
            record(f"K6 {label} {s}", lambda: cg.solve_gnlse_batch_cuda(*t, nl=nl_t, **gkw))
        t7 = lle_lanes(psa, rdt, dev)
        record(f"K7 {s}", lambda: cl.solve_lle_batch_cuda(*t7, dt=LLE_DT, n_steps=LLE_STEPS,
                                                          save_every=LLE_SAVE))
        for coupling, nl, bire in VG_CASES[:1] + VG_CASES[2:]:
            t9, coh, nl_t = vgnlse_lanes(psa, rdt, dev, coupling, nl, bire)
            record(f"K9 {cv.body_of(coh, nl_t)} {s}",
                   lambda: cv.solve_vgnlse_batch_cuda(*t9, coh, nl=nl_t, **gkw))
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
