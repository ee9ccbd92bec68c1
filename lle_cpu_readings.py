#!/usr/bin/env python3
"""CPU readings of the LLE plain versions that set chip_smoke.py's LLE bars.

Run from the root of a checkout (no card needed; a few minutes on 4 cores):

    python3 lle_cpu_readings.py

At the bench_lle.py configuration (T = 256, Delta in [3.6, 4.4], F = 2,
d2 = -1, 2,000 steps of 0.01, soliton-ansatz seeds) on a few cavities of
the port's plain versions, float64 unless said:

1. K7's yardsticks: what a 0.1% error in F, and the plain fp32 version,
   read against the plain fp64 version (A_end normwise, peak relative);
2. K8-LLE's at rtol 1e-5/atol 1e-8: the plain fp32 version and F 0.1% off;
3. the rk45 subset's reference, in relative power (bench_lle.py:277-284):
   rk4ip45 at rtol 1e-10 against rtol 1e-11, rk45 x64 (rtol 1e-8) against
   the latter, rk45 x64 at rtol 1e-5 and rk45 x32 (rtol 1e-5) against the
   former;
4. attempts a cavity: rk45 at rtol 1e-8, rk4ip45 at rtol 1e-8;
5. the detuning scan on 64 points: the share whose peak is above twice the
   lower CW branch.
"""

import numpy as np
import torch

import psa_torch as psa
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa

LL = psa.lle
GRID = LL.TimeGrid(n_samples=256, t_window_s=20.0)
DETUNINGS = np.linspace(3.6, 4.4, 4096)
KW = dict(dt=0.01, n_steps=2000, save_every=200)


def lanes(idx, rdt=torch.float64):
    dets = DETUNINGS[idx]
    co = LL.make_lle_coeffs(GRID, detuning=dets, pump=2.0, d2=-1.0)
    psi0 = np.stack([LL.soliton_ansatz(GRID, d, 2.0, -1.0) for d in dets])
    det, F, ph = LL.lane_coeffs(co, len(dets), 256, rdt, "cpu")
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return torch.as_tensor(psi0).to(cdt), det, F, ph


def normwise(a, b):
    a, b = a.to(torch.complex128), b.to(torch.complex128)
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def peak_err(a, b):
    return float(((a.double() - b) / b).abs().max())


def power_err(a, b):
    P, P_ref = a.to(torch.complex128).abs() ** 2, b.abs() ** 2
    return float((P - P_ref).abs().max() / P_ref.max())


def main():
    torch.set_num_threads(4)
    idx8 = np.linspace(0, 4095, 8).astype(int)
    t64, t32 = lanes(idx8), lanes(idx8, torch.float32)
    r64 = cl.solve_lle_batch_torch(*t64, **KW)
    off = cl.solve_lle_batch_torch(t64[0], t64[1], t64[2] * (1 + 1e-3), t64[3], **KW)
    r32 = cl.solve_lle_batch_torch(*t32, **KW)
    print(f"1. K7, 8 cavities: F 0.1% off A_end {normwise(off.A_end, r64.A_end):.3e}, peak "
          f"{peak_err(off.peak_max, r64.peak_max):.3e}; plain fp32 A_end "
          f"{normwise(r32.A_end, r64.A_end):.3e}, peak {peak_err(r32.peak_max, r64.peak_max):.3e}")

    a64 = lanes(idx8[:2])
    k5 = dict(KW, rtol=1e-5, atol=1e-8)
    s64 = csa.solve_lle_batch_rk45_torch(*a64, **k5)
    s32 = csa.solve_lle_batch_rk45_torch(*lanes(idx8[:2], torch.float32), **k5)
    soff = csa.solve_lle_batch_rk45_torch(a64[0], a64[1], a64[2] * (1 + 1e-3), a64[3], **k5)
    print(f"2. K8-LLE at rtol 1e-5, 2 cavities: plain fp32 A_end "
          f"{normwise(s32.A_end, s64.A_end):.3e}; F 0.1% off {normwise(soff.A_end, s64.A_end):.3e}")

    sub = np.linspace(0, 511, 8).astype(int)       # the rk45 subset of chip_smoke.py
    ref = csa.solve_lle_batch_rk45_torch(*lanes(sub), rtol=1e-10, atol=1e-13, method="rk4ip",
                                         **KW)
    x32 = csa.solve_lle_batch_rk45_torch(*lanes(sub, torch.float32), **k5)
    ends = lanes(sub[[0, -1]])                      # its first and last cavity
    ref_e = ref.A_end[[0, -1]]
    ref11 = csa.solve_lle_batch_rk45_torch(*ends, rtol=1e-11, atol=1e-14, method="rk4ip", **KW)
    x64 = csa.solve_lle_batch_rk45_torch(*ends, rtol=1e-8, atol=1e-11, **KW)
    x64_5 = csa.solve_lle_batch_rk45_torch(*ends, **k5)
    ip8 = csa.solve_lle_batch_rk45_torch(*ends, rtol=1e-8, atol=1e-11, method="rk4ip", **KW)
    print(f"3. relative power: rk4ip45 rtol 1e-10 against 1e-11 "
          f"{power_err(ref_e, ref11.A_end):.3e}; rk45 x64 (rtol 1e-8) against rk4ip45 1e-11 "
          f"{power_err(x64.A_end, ref11.A_end):.3e}; against rk4ip45 at rtol 1e-10: rk45 x64 at "
          f"rtol 1e-5 {power_err(x64_5.A_end, ref_e):.3e}, rk45 x32 (8 cavities, each) "
          f"{[f'{power_err(x32.A_end[i:i + 1], ref.A_end[i:i + 1]):.2e}' for i in range(8)]}")
    att = (lambda r: (r.n_accepted + r.n_rejected).tolist())
    print(f"4. attempts a cavity: rk45 rtol 1e-8 {att(x64)}, rk4ip45 rtol 1e-8 {att(ip8)}, "
          f"rk45 rtol 1e-5 fp32 {att(x32)}")

    cfg = psa.custom_simulation_config(z_max=20.0, dz=0.01, save_every=200)
    det, _mean, pk, _psi, ok = LL.detuning_scan(cfg, GRID, detunings=np.linspace(0.5, 4.5, 64),
                                                pump=2.0, d2=-1.0, device="cpu")
    lower = np.array([LL.cw_steady_states(d, 2.0)[0] for d in det])
    print(f"5. detuning scan, 64 points: ok {bool(ok.all())}, share above twice the lower "
          f"branch {np.mean(pk > 2.0 * lower):.3f}")


if __name__ == "__main__":
    main()
