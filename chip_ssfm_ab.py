#!/usr/bin/env python3
"""Time the CUDA kernels of one checkout on one CUDA card, so that two trees
can be compared in one call.

Run from the root of a checkout:

    python3 chip_ssfm_ab.py [--root DIR] [--reps 5] [--out FILE]

``--root DIR`` imports the package from another checkout (its kernels are
built under ``DIR/build/``).  Run it in turns, for example parent, change,
change, parent, in one command on one card, and compare the medians.

At ``chip_smoke.py``'s sizes, each figure the median of ``--reps`` warm
calls of the kernel's wrapper (host clock with synchronize, ``chip_smoke.
timed``):

- K1/K2 (``csrc/fwm4_rk.cu``), 10^4 lanes, 2,500 rk4 steps, and K3
  (``csrc/fwm4_rk45.cu``), fp64 and fp32; K1 fp64 at 250,000 lanes; K3 at
  50,000, 100,000 and 250,000 lanes too (``K3_BATCHES``), where its
  launcher runs a lane on one thread;
- K4 (``csrc/comb_rk.cu``), 4,096 combs of 64 lines, 1,000 steps: rk4 fp64
  and fp32, ab4 and abm4 fp64; K5 (``csrc/comb_rk45.cu``) fp64 and fp32;
- K6 (``csrc/gnlse_ssfm.cu``), 2,048 envelopes of 1,024 samples, 1,000
  steps: Kerr; nl with Raman (f_R = 0.18) and self-steepening; nl with
  steepening only (f_R = 0) and with Raman only (no steepening), whose
  differences from the full nl time are the Raman pairs' and the
  steepening pairs' share; fp64 and fp32;
- K7 (``csrc/lle_ssfm.cu``), 4,096 cavities of 256 samples, 2,000 steps;
- K8 (``csrc/ssfm_rk45.cu``): the LLE route on 512 cavities of 256 samples,
  2,000 steps at rtol 1e-8 (fp64) and 1e-5 (fp32); the GNLSE route on 512
  envelopes of 1,024 samples, 1,000 steps at rtol 1e-9 and 1e-5;
- K9 (``csrc/vgnlse_ssfm.cu``), 1,024 instances of 2 x 1,024 samples,
  1,000 steps: rotation (manakov), coherent (isotropic) and nl (manakov,
  Raman and steepening), fp64 and fp32;
- the attempts a lane of the adaptive kernels (K3, K5, K8; mean over
  lanes), which two trees must agree on where the kernel did not change;
- a SHA-256 of each kernel's outputs on these inputs, which shows whether
  two trees' kernels give the same outputs bit for bit;
- the kernels' registers and spills from the build log (``-Xptxas -v``).

It prints the card's name and power limit, one line a time, and as its last
line a JSON object of all of these; ``--out`` also writes it to a file.
Without a CUDA device it exits non-zero.
"""

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import (COMB_STEPS, COMB_SAVE, COMB_TOL, COMB_Z, GN_B45, GN_OMEGA0, GN_SAVE,
                        GN_STEPS, GN_T, GN_T0, GN_TOL, GN_Z, LLE_B45, LLE_DT, LLE_SAVE, LLE_STEPS,
                        LLE_TOL, N_POINTS, N_STEADY, RK45_TOL, VG_CASES, bench_common, comb_lanes,
                        gnlse_lanes, lanes, lle_lanes, suffix, timed, vgnlse_lanes)

# K3's larger batches, 256 lanes an SM and more on an H100
K3_BATCHES = (50_000, 100_000, N_STEADY)


def digest(res):
    """SHA-256 of every tensor of a result (a dataclass or a tuple)."""
    h = hashlib.sha256()
    fields = ([getattr(res, f.name) for f in dataclasses.fields(res)]
              if dataclasses.is_dataclass(res) else res)
    for v in fields:
        if isinstance(v, torch.Tensor):
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive as ca
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb as cc
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb_adaptive as cca
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_solver as cs
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_vgnlse as cv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    root = str(Path(psa.__file__).resolve().parent)
    out = {"root": root, "card": card, "torch": torch.__version__, "reps": args.reps, "ms": {},
           "sha": {}, "attempts": {}}
    _build.build()
    out["ptxas"] = [line.strip() for line in _build.build_log().splitlines()
                    if "registers" in line or "spill" in line or "Compiling entry" in line]

    def record(label, fn, attempts=False):
        res = fn()
        torch.cuda.synchronize()
        out["sha"][label] = digest(res)
        if attempts:
            out["attempts"][label] = float((res.n_accepted + res.n_rejected).double().mean())
        out["ms"][label] = 1e3 * timed(fn, reps=args.reps)
        extra = f", {out['attempts'][label]:.1f} attempts a lane" if attempts else ""
        print(f"{root}: {label} {out['ms'][label]:.3f} ms{extra} (sha {out['sha'][label]})",
              flush=True)

    common = bench_common(psa)
    gn = psa.gnlse
    grid = gn.TimeGrid.for_pulse(GN_T0, n_samples=GN_T)
    gkw = dict(dz_m=GN_Z / GN_STEPS, n_steps=GN_STEPS, save_every=GN_SAVE)
    ckw = dict(dz_m=COMB_Z / COMB_STEPS, n_steps=COMB_STEPS, save_every=COMB_SAVE)
    lkw = dict(dt=LLE_DT, n_steps=LLE_STEPS, save_every=LLE_SAVE)
    for rdt in (torch.float64, torch.float32):
        s = suffix(rdt)
        t = lanes(psa, common, N_POINTS, rdt, dev)
        record(f"K1/K2 rk4 {s}", lambda: cs.solve_batch_cuda(
            *t, dz_m=0.2, n_steps=2500, save_every=10, integrator="rk4"))
        if rdt == torch.float64:
            t1 = lanes(psa, common, N_STEADY, rdt, dev)
            record(f"K1 rk4 {s} {N_STEADY} lanes", lambda: cs.solve_batch_cuda(
                *t1, dz_m=0.2, n_steps=2500, save_every=10, integrator="rk4"))
        rtol, atol = RK45_TOL[rdt]
        record(f"K3 {s}", lambda: ca.solve_batch_rk45_cuda(
            *t, dz_m=0.2, n_steps=2500, save_every=10, rtol=rtol, atol=atol), attempts=True)
        for B in K3_BATCHES:
            t3 = lanes(psa, common, B, rdt, dev)
            record(f"K3 {s} {B} lanes", lambda: ca.solve_batch_rk45_cuda(
                *t3, dz_m=0.2, n_steps=2500, save_every=10, rtol=rtol, atol=atol),
                attempts=True)
        tc = comb_lanes(psa, rdt, dev)
        for method in ("rk4", "ab4", "abm4") if rdt == torch.float64 else ("rk4",):
            record(f"K4 {method} {s}", lambda: cc.solve_comb_batch_cuda(
                *tc, **ckw, integrator=method))
        rtol, atol = COMB_TOL[rdt]
        record(f"K5 {s}", lambda: cca.solve_comb_batch_rk45_cuda(
            *tc, **ckw, rtol=rtol, atol=atol), attempts=True)
        t6, _ = gnlse_lanes(psa, rdt, dev)
        record(f"K6 kerr {s}", lambda: cg.solve_gnlse_batch_cuda(*t6, **gkw))
        for label, f_r, w0 in (("nl", 0.18, GN_OMEGA0), ("nl f_R=0", 0.0, GN_OMEGA0),
                               ("nl no steepening", 0.18, None)):
            nl_t = gn._cast_nl(gn.make_nl_terms(grid, f_raman=f_r, omega0=w0), rdt, dev)
            record(f"K6 {label} {s}", lambda: cg.solve_gnlse_batch_cuda(*t6, nl=nl_t, **gkw))
        t7 = lle_lanes(psa, rdt, dev)
        record(f"K7 {s}", lambda: cl.solve_lle_batch_cuda(*t7, **lkw))
        rtol, atol = LLE_TOL[rdt]
        t8 = lle_lanes(psa, rdt, dev, B=LLE_B45)
        kw8 = dict(lkw, rtol=rtol, atol=atol, max_steps=200_000)
        record(f"K8 lle {s}", lambda: csa.solve_lle_batch_rk45_cuda(*t8, **kw8), attempts=True)
        rtol, atol = GN_TOL[rdt]
        t8g, _ = gnlse_lanes(psa, rdt, dev, B=GN_B45)
        record(f"K8 gnlse {s}", lambda: csa.solve_gnlse_batch_rk45_cuda(
            *t8g, **gkw, rtol=rtol, atol=atol, max_steps=20_000), attempts=True)
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
