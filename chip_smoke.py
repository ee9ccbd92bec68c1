#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device: a CUDA device must be present; its name and power limit are
   printed, TF32 is switched off;
2. build: the CUDA kernels are compiled from ``csrc/`` (first use);
3. kernel vs plain version on the card, at the main path's shapes: the
   bench configuration's 10^4 lanes (a ragged last block) with one lane made
   to blow up, 2,500 steps, and one run with a trailing partial save
   interval: fp64 rk4/ab4/abm4 within rtol 1e-11, fp32 rk4 within rtol 1e-4,
   equal ``ok`` flags, the bad lane frozen and finite;
4. the main path at full size: ``gain_spectrum`` over 10^4 points at
   ``precision='df32'`` and ``'x32'`` through the kernel (launch counter),
   checked against the plain fp64 version on the CPU and the reference
   goldens;
5. times (median of 5 warm reps) of the kernel and of the plain version;
6. one ``run_single_simulation`` on the card against the 45.292 dB anchor.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_POINTS = 10_000
N_STEADY = 250_000
REPS = 5


def log(msg):
    print(msg, flush=True)


def bench_common(psa):
    """The main_gain_spectrum configuration of bench.py:190-220."""
    lam_p1, lam_p2 = 1550e-9, 1555e-9
    omega = psa.plan_from_wavelengths(lam_p1, lam_p2, 1540e-9)
    sp = psa.infer_symmetry_from_omegas(*omega)
    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(psa.lambda_from_omega(sp.omega_c)), D=0.2, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(sp.omega_c),
    )
    pm = psa.PhaseMatchingConfig(method=psa.PhaseMatchingMethod.SYMMETRIC_EVEN,
                                 even_orders=(2, 4), max_order=4)
    return dict(
        lambda_p1_m=lam_p1, lambda_p2_m=lam_p2, gamma=11.5 / 1000.0,
        alpha=(np.log(10.0) / 10.0) * 0.5 / 1000.0, p_in=np.array([0.5, 0.5, 1e-7, 1e-7]),
        phase_in=np.zeros(4), dispersion=disp, phase_matching_cfg=pm, length_unit="m",
        gain_unit="dB", frame="rotating",
    )


def cfg_for(psa, precision):
    return psa.custom_simulation_config(z_max=500.0, dz=0.2, save_every=10, precision=precision)


def lanes(psa, common, n, rdt, device):
    """(A0, gamma, alpha, dbeta) tensors of the bench configuration for n
    signal wavelengths across the band."""
    lam3 = np.linspace(1540e-9, 1650e-9, n)
    _, dbeta = psa.dbeta_spectrum(
        lambda_p1_m=common["lambda_p1_m"], lambda_p2_m=common["lambda_p2_m"],
        lambda_signal_m=lam3, dispersion=common["dispersion"],
        phase_matching_cfg=common["phase_matching_cfg"], device=device)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    a0 = np.sqrt(common["p_in"]).astype(np.complex128)
    A0 = torch.as_tensor(np.broadcast_to(a0, (n, 4)).copy(), dtype=cdt, device=device)
    full = dict(dtype=rdt, device=device)
    return (A0, torch.full((n,), common["gamma"], **full),
            torch.full((n,), common["alpha"], **full), torch.as_tensor(dbeta, **full))


def timed(fn, reps=REPS):
    """Median wall time of ``reps`` warm calls, each synchronized."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def lin(gain_db):
    return 10.0 ** (np.asarray(gain_db) / 10.0)


def main():
    # --- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False -- this check needs "
                 "a CUDA card and never runs on the CPU")
    import psa_torch as psa
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_solver as cs

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False")

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    log(f"build: {lib.name} ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.find_nvcc()})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    common = bench_common(psa)

    # --- 3. kernel vs plain version on the card --------------------------------
    B, bad = N_POINTS, N_POINTS // 2
    max_err = {torch.float64: 0.0, torch.float32: 0.0}
    cases = [(torch.float64, m, 2500) for m in ("rk4", "ab4", "abm4")]
    cases += [(torch.float64, "rk4", 2497), (torch.float32, "rk4", 2500),
              (torch.float32, "rk4", 2497)]
    for rdt, method, n_steps in cases:
        A0, g, a, db = lanes(psa, common, B, rdt, dev)
        A0[bad] = torch.tensor([1e4, 1e4, 1.0, 0.0], dtype=A0.dtype)
        g[bad] = 1e3                                   # this lane must blow up
        kw = dict(dz_m=0.2, n_steps=n_steps, save_every=10, integrator=method)
        rk = cs.solve_batch_cuda(A0, g, a, db, **kw)
        rp = cs.solve_batch_torch(A0, g, a, db, **kw)
        torch.cuda.synchronize()
        rtol = 1e-11 if rdt == torch.float64 else 1e-4
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{method} {rdt} n={n_steps}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{method} {rdt}: expected exactly lane {bad} to fail")
        for name, k, p in (("P_max", rk.P_max, rp.P_max), ("A_end", rk.A_end, rp.A_end)):
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"{method} {rdt} {name}: non-finite kernel output")
            diff = (k - p).abs()
            rel = float((diff / p.abs().clamp_min(torch.finfo(p.real.dtype).tiny)).max())
            max_err[rdt] = max(max_err[rdt], float(diff.max()))
            log(f"kernel vs plain {str(rdt)[6:]} {method} B={B} n_steps={n_steps} {name}: "
                f"max rel err {rel:.3e} (bar {rtol:g})")
            if not rel <= rtol:
                raise AssertionError(f"{method} {rdt} {name}: {rel:.3e} > {rtol:g}")

    # --- 4. the main path at full size ------------------------------------------
    lam3 = np.linspace(1540e-9, 1650e-9, N_POINTS)
    launches = {}
    for precision, rdt in (("df32", torch.float64), ("x32", torch.float32)):
        cs.LAUNCHES = 0
        res = psa.gain_spectrum(cfg=cfg_for(psa, precision), lambda_signal_m=lam3,
                                device="cuda", engine="auto", **common)
        launches[rdt] = cs.LAUNCHES
        ok_frac = float(res.ok.mean())
        log(f"main path {precision}: {N_POINTS} points, {launches[rdt]} kernel launch(es), "
            f"ok {ok_frac:.4f}, peak gain {np.nanmax(res.gain):.4f} dB, "
            f"{res.points_per_s:.1f} pts/s (first call)")
        if launches[rdt] < 1:
            raise AssertionError(f"{precision}: the main path did not launch the kernel")
        if res.gain.shape != (N_POINTS,) or ok_frac < 0.99:
            raise AssertionError(f"{precision}: bad result (shape {res.gain.shape}, ok {ok_frac})")
        if not np.isfinite(res.gain[res.ok]).all():
            raise AssertionError(f"{precision}: non-finite gain on ok points")

    sub = np.linspace(1541e-9, 1649e-9, 32)
    ref = psa.gain_spectrum(cfg=cfg_for(psa, "x64"), lambda_signal_m=sub, device="cpu",
                            engine="torch", **common)
    for precision, bar in (("df32", 1e-11), ("x32", 1e-4)):
        fast = psa.gain_spectrum(cfg=cfg_for(psa, precision), lambda_signal_m=sub,
                                 device="cuda", **common)
        err = float(np.nanmax(np.abs(lin(fast.gain) / lin(ref.gain) - 1.0)))
        log(f"32-point subset {precision} (card, kernel) vs plain fp64 (CPU): "
            f"max rel err {err:.3e} in linear gain (bar {bar:g})")
        if not err <= bar:
            raise AssertionError(f"{precision} subset error {err:.3e} > {bar:g}")

    g = np.load(ROOT / "tests" / "golden" / "golden_bench_config.npz")
    gdisp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(g["lambda_c"]), D=float(g["D"]), S=float(g["S"]), dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(g["omega_c"]), compat_reference_beta4_bug=True)
    gres = psa.gain_spectrum(
        cfg=cfg_for(psa, "df32"), lambda_signal_m=np.asarray(g["lam3"]),
        **{**common, "dispersion": gdisp, "gamma": float(g["gamma"]),
           "alpha": float(g["alpha"]), "p_in": np.asarray(g["p_in"]),
           "lambda_p1_m": float(g["lam1"]), "lambda_p2_m": float(g["lam2"])},
        device="cuda")
    gerr = float(np.max(np.abs(lin(gres.gain) / lin(g["gain_db"]) - 1.0)))
    log(f"golden_bench_config (16 points, rotating frame, kernel): max rel err {gerr:.3e} "
        "in linear gain (bar 2e-9)")
    if not gerr <= 2e-9:
        raise AssertionError(f"golden bench config error {gerr:.3e} > 2e-9")

    # --- 5. times ----------------------------------------------------------------
    kw = dict(dz_m=0.2, n_steps=2500, save_every=10, integrator="rk4")
    ms, plain_ms = {}, {}
    for rdt in (torch.float64, torch.float32):
        t = lanes(psa, common, N_POINTS, rdt, dev)
        ms[rdt] = 1e3 * timed(lambda: cs.solve_batch_cuda(*t, **kw))
        plain_ms[rdt] = 1e3 * timed(lambda: cs.solve_batch_torch(*t, **kw))
    t = lanes(psa, common, N_STEADY, torch.float64, dev)
    ms_steady = 1e3 * timed(lambda: cs.solve_batch_cuda(*t, **kw))
    e2e = {}
    for precision in ("df32", "x32"):
        e2e[precision] = timed(lambda: psa.gain_spectrum(
            cfg=cfg_for(psa, precision), lambda_signal_m=lam3, device="cuda", **common))
    log(f"times on {card} (median of {REPS} warm reps, 2,500 rk4 steps per point):")
    for rdt in (torch.float64, torch.float32):
        name = str(rdt)[6:]
        log(f"  kernel {name} {N_POINTS} points: {ms[rdt]:.3f} ms = "
            f"{N_POINTS / ms[rdt] * 1e3:.1f} pts/s; plain torch on the card: "
            f"{plain_ms[rdt]:.1f} ms = {N_POINTS / plain_ms[rdt] * 1e3:.1f} pts/s")
    log(f"  kernel float64 {N_STEADY} points: {ms_steady:.3f} ms = "
        f"{N_STEADY / ms_steady * 1e3:.1f} pts/s")
    for precision, sec in e2e.items():
        log(f"  gain_spectrum end to end, {precision}, {N_POINTS} points: {sec * 1e3:.3f} ms = "
            f"{N_POINTS / sec:.1f} pts/s")

    # --- 6. single run on the card ---------------------------------------------
    omega = psa.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9)
    sp = psa.infer_symmetry_from_omegas(*omega)
    adisp = psa.dispersion_params_from_D_S(
        lambda_ref_m=float(psa.lambda_from_omega(sp.omega_c)), D=0.02, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(sp.omega_c), compat_reference_beta4_bug=True)
    t0 = time.perf_counter()
    z, A = psa.run_single_simulation(
        psa.custom_simulation_config(z_max=1000.0, dz=0.1), gamma=11.5 / 1000.0,
        alpha=(np.log(10.0) / 10.0) * 0.9 / 1000.0, omega=omega.cpu().numpy(),
        p_in=np.array([0.5, 0.5, 1e-5, 1e-5]), phase_in=np.zeros(4), dispersion=adisp,
        phase_matching_cfg=psa.PhaseMatchingConfig(
            method=psa.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4),
        length_unit="m", return_length_unit="m", device="cuda")
    gain_db = float(10 * np.log10(np.abs(A[-1, 2]) ** 2 / 1e-5))
    log(f"run_single_simulation on the card (10,000 steps, plain torch): {gain_db:.6f} dB "
        f"in {time.perf_counter() - t0:.1f} s (anchor 45.292 +- 1e-3)")
    if A.shape != (1001, 4) or not np.isfinite(A).all() or abs(gain_db - 45.292) > 1e-3:
        raise AssertionError(f"single run: shape {A.shape}, gain {gain_db} dB")

    source = "psa_simulation_ode_rk_mvp_dispersion_tpu_torch/csrc/fwm4_rk.cu"
    replaces = {
        torch.float64: "psa_simulation_ode_rk_mvp_dispersion_tpu/ops/pallas_df32.py:442",
        torch.float32: "psa_simulation_ode_rk_mvp_dispersion_tpu/ops/pallas_solver.py:300",
    }
    print(json.dumps({"kernels": [
        {"name": f"fwm4_rk_{'f64' if rdt == torch.float64 else 'f32'}", "route": "cuda",
         "source": source, "replaces": replaces[rdt], "launches": launches[rdt],
         "max_abs_err": max_err[rdt], "ms": ms[rdt], "plain_ms": plain_ms[rdt]}
        for rdt in (torch.float64, torch.float32)
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
