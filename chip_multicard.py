#!/usr/bin/env python3
"""The batch split over several cards of one machine (``parallel/mesh``).

Run from the root of a checkout on a machine with two or more CUDA cards:

    python3 chip_multicard.py

1. One process, a mesh over every card (``default_mesh()``): the main
   path's ``gain_spectrum`` at 10^4 points (df32 rk4, K1; df32 rk45, K3)
   and at 250,000 points (df32 rk4), and every family at the size
   ``chip_smoke.py`` drives it (comb K4/K5, GNLSE K6/K6 nl/K8, LLE K7/K8,
   vector K9's three bodies; SBS is left out: plain torch, no kernel),
   each with the launch counts cleared before and read after (one launch
   a card), held to the unsharded call on ``cuda:0`` at the JAX package's
   mesh bars (``chip_smoke.held``), and both wall times (median of 3 warm
   reps, host clock with synchronize).
2. One process a card: the worker of ``tests/test_torch_multihost.py`` on
   every card over NCCL, each process two slots of its own card, a
   (dcn=n, batch=2) mesh, every process's gathered spectrum held to its
   unsharded one.

Prints the cards' names and power limits; exits non-zero on any miss.
"""

import functools
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

REPS = 3


def main():
    if torch.cuda.device_count() < 2:
        sys.exit("chip_multicard: needs two or more CUDA cards")
    import psa_torch as psa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cards = smi.splitlines()
    n = torch.cuda.device_count()
    cs.log(f"{n} cards: {'; '.join(cards)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for name in _build.build():
        _build.load_library(name)
    cs.log(f"build {time.perf_counter() - t0:.1f} s")

    mesh = psa.default_mesh()
    if mesh is None or mesh.size != n:
        raise AssertionError(f"default_mesh() over {n} cards: {mesh}")
    common = cs.bench_common(psa)
    nw, gn, ll, vg = psa.nwave, psa.gnlse, psa.lle, psa.vgnlse
    calls = []
    for label, cfg, lanes, name in (
            ("gain_spectrum rk4 df32", cs.cfg_for(psa, "df32"), cs.N_POINTS, "fwm4_rk_f64"),
            ("gain_spectrum rk45 df32", cs.cfg45_for(psa, "df32"), cs.N_POINTS, "fwm4_rk45_f64"),
            ("gain_spectrum rk4 df32", cs.cfg_for(psa, "df32"), cs.N_STEADY, "fwm4_rk_f64")):
        lam3 = np.linspace(1540e-9, 1650e-9, lanes)
        calls.append((f"{label}, {lanes} points", name, functools.partial(
            lambda cfg, lam3, m, d: psa.gain_spectrum(cfg=cfg, lambda_signal_m=lam3, mesh=m,
                                                      device=d, **common), cfg, lam3),
            lambda r: (np.where(r.ok, r.gain, 0.0), r.ok), (("rtol", 1e-10), ("equal",))))
    A0c, coc = cs.comb_setup(psa)
    for integ, name, prec in (("rk4", "comb_rk_f64", "df32"), ("rk45", "comb_rk45_f64", "x64")):
        cfg = cs.comb_cfg(psa, prec, integ)
        calls.append((f"comb {integ} {prec}, {cs.COMB_B} combs", name, functools.partial(
            lambda cfg, m, d: nw.solve_comb_batch(cfg, coc, A0c, mesh=m, device=d), cfg),
            tuple, (("rtol", 1e-12), ("normwise", 1e-12), ("equal",))))
    gn_bars = (("rtol", 1e-11), ("atol", 1e-11), ("equal",))
    for label, name, prec, nl, integ, B in (
            ("Kerr", "gnlse_ssfm_f64", "df32", False, "rk4", cs.GN_B),
            ("nl", "gnlse_ssfm_nl_f64", "df32", True, "rk4", cs.GN_B),
            ("rk45", "ssfm_rk45_f64", "x64", False, "rk45", cs.GN_B45)):
        A0, co, terms = cs.gnlse_setup(psa, prec, nl, B)
        r, a = cs.GN_TOL[torch.float64]
        cfg = psa.custom_simulation_config(z_max=cs.GN_Z, dz=cs.GN_Z / cs.GN_STEPS,
                                           save_every=cs.GN_SAVE, precision=prec,
                                           integrator=integ, rtol=r, atol=a)
        calls.append((f"GNLSE {label} {prec}, {B} envelopes", name, functools.partial(
            lambda cfg, A0, co, terms, m, d: gn.solve_gnlse_batch(
                cfg, co, A0, nl=terms, mesh=m, device=d), cfg, A0, co, terms),
            tuple, gn_bars))
    for integ, name, prec, B in (("rk4", "lle_ssfm_f64", "df32", cs.LLE_B),
                                 ("rk45", "ssfm_rk45_lle_f64", "x64", cs.LLE_B45)):
        psi0, co = cs.lle_setup(psa, prec, B)
        cfg = cs.lle_cfg_for(psa, prec, integ)
        bars = ((("rtol", 1e-12), ("rtol", 1e-12, 1e-18), ("equal",)) if integ == "rk4" else
                (("rtol", 1e-9), ("scaled", 1e-9), ("equal",)))
        calls.append((f"LLE {integ} {prec}, {B} cavities", name, functools.partial(
            lambda cfg, psi0, co, m, d: ll.solve_lle_batch(cfg, co, psi0, mesh=m, device=d),
            cfg, psi0, co), tuple, bars))
    for label, name, coupling, nl in (("manakov", "vgnlse_ssfm_f64", "manakov", False),
                                      ("isotropic", "vgnlse_ssfm_coherent_f64", "isotropic",
                                       False),
                                      ("manakov nl", "vgnlse_ssfm_nl_f64", "manakov", True)):
        A0, co, terms = cs.vgnlse_setup(psa, "df32", coupling, nl)
        cfg = psa.custom_simulation_config(z_max=cs.GN_Z, dz=cs.GN_Z / cs.GN_STEPS,
                                           save_every=cs.GN_SAVE, precision="df32")
        calls.append((f"vector {label} df32, {A0.shape[0]} instances", name, functools.partial(
            lambda cfg, A0, co, terms, m, d: vg.solve_vgnlse_batch(
                cfg, co, A0, nl=terms, mesh=m, device=d), cfg, A0, co, terms),
            tuple, gn_bars))

    cs.log(f"1. one process, {mesh}; unsharded on cuda:0 ({cards[0]}); wall times median of "
           f"{REPS} warm reps, host clock with synchronize:")
    for label, name, call, outputs, bars in calls:
        got = {}
        for key, m, d, want in (("plain", None, "cuda:0", 1), ("sharded", mesh, None, n)):
            _build.LAUNCHES.clear()
            got[key] = call(m, d)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            if counts != {name: want}:
                raise AssertionError(f"{label} {key}: launches {counts}, expected {want}")
        t_plain = cs.timed(lambda: call(None, "cuda:0"), reps=REPS)
        t_sharded = cs.timed(lambda: call(mesh, None), reps=REPS)
        cs.log(cs.held(f"{label}: {n} launches of {name}", outputs(got["sharded"]),
                       outputs(got["plain"]), bars))
        cs.log(f"    wall time sharded {1e3 * t_sharded:.3f} ms, unsharded {1e3 * t_plain:.3f} "
               f"ms: {t_plain / t_sharded:.3f}x")

    sys.path.insert(0, str(cs.ROOT / "tests"))
    import test_torch_multihost as tmh

    t0 = time.perf_counter()
    results = tmh.run_cluster("cuda:{rank}", nproc=n, backend="nccl")
    sec = time.perf_counter() - t0
    for rank, (code, out) in enumerate(results):
        lines = [ln for ln in out.splitlines() if "bit for bit" in ln or "MULTIHOST_OK" in ln]
        cs.log(f"2. NCCL worker {rank} on cuda:{rank}: exit {code}; " + "; ".join(lines))
        if code != 0 or f"MULTIHOST_OK p{rank}/{n} mesh={{'dcn': {n}, 'batch': 2}}" not in out:
            raise AssertionError(f"NCCL worker {rank} failed (code {code}):\n{out[-3000:]}")
    cs.log(f"   the {n}-process NCCL cluster: {sec:.1f} s from start to every exit")
    cs.log("MULTICARD OK")


if __name__ == "__main__":
    main()
