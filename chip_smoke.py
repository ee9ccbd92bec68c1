#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device: a CUDA device must be present; its name and power limit are
   printed, TF32 is switched off;
2. build: the CUDA kernels are compiled from ``csrc/`` (first use, one
   ``nvcc`` per source, all at once); registers and spills are printed;
3. fixed-step kernel vs plain version on the card, at the main path's
   shapes: the bench configuration's 10^4 lanes with one lane made to blow
   up, 2,500 steps, and runs with a trailing partial save interval: fp64
   rk4/ab4/abm4 within rtol 1e-11, fp32 rk4 within rtol 1e-4, equal ``ok``
   flags, the bad lane frozen and finite;
4. adaptive (rk45) kernel vs plain version on the card, 10^4 lanes, a bad
   lane, over the first 100 m of the main path's fiber (its plain version's
   time follows its step count, not its lanes; phase 6 drives the kernel
   over the full 500 m): fp64 at rtol 1e-10/atol 1e-13, 500 steps, and fp32
   at rtol 1e-6/atol 1e-10 with a trailing partial span (497 steps) and
   with ``save_every=7`` (500 steps): equal ``ok``, the bad lane frozen
   and finite, step counters equal on >= 99% of lanes, fp64 within 1e-11 on
   the lanes whose counters agree and 10 x rtol on all, fp32 within 1e-4;
5. the rk4 main path: ``gain_spectrum`` over 10^4 points at ``df32`` and
   ``x32`` through the kernel (launch counts), against the plain fp64
   version on the CPU and the reference goldens;
6. the rk45 main path: ``gain_spectrum(integrator='rk45')`` over 10^4
   points at ``df32`` and ``x32`` through the rk45 kernel, its 32-point
   subset against the plain fp64 rk45 version on the CPU at rtol 1e-11;
7. the other sweeps, each once on the card against the plain version of
   the same call: ``gain_map_power_wavelength`` (16 x 640 cells, df32),
   ``mismatch_scan`` and ``psa_phase_sweep`` (rk45, x32),
   ``solve_batch_trajectories`` (plain torch, against the CPU);
8. the default device: ``gain_spectrum`` with ``device`` left out launches
   the kernel;
9. times (median of 5 warm reps) of the kernels and of ``gain_spectrum``
   end to end; the plain versions are timed once each, in phases 3 and 4.
   Beside K3's time: its attempts a lane (mean, max, max / mean) and the
   tail lane's time an attempt (the kernel's time over the max); beside
   each 4-wave kernel's: its launch (threads a lane, ptxas's registers and
   spills, warps in all and resident at once);
10. one ``run_single_simulation`` on the card against the 45.292 dB anchor;
11. comb kernel K4 (``csrc/comb_rk.cu``) vs its plain version on the card at
    the ``bench_comb.py`` configuration (N = 64 lines, 4,096 combs over a
    gamma grid, 1,000 steps over 500 m, ``save_every=100``) with one comb
    made to blow up, 1,000 steps for rk4 and 500 for ab4 and abm4, and a
    run with a trailing partial interval (505 steps, rk4): fp64
    rk4/ab4/abm4 within 1e-11 and fp32 rk4 within 1e-4 of each
    comb's largest value (normwise: a weak line carries the cubic sum's
    rounding relative to the pumps), equal ``ok``, the bad comb frozen and
    finite;
12. comb kernel K5 (``csrc/comb_rk45.cu``) vs its plain version, same
    configuration, fp64 at rtol 1e-9/atol 1e-12 and fp32 at 1e-6/1e-10
    (``bench_comb.py:305-306``), with a bad comb, 1,000 steps and, in
    fp64, a trailing partial interval (505 steps): fp64 step counters equal
    on >= 99% of combs, results within 1e-9 there and 10 x rtol on all;
    fp32 equal ``ok`` and ``P_max`` and ``A_end`` within 1e-3 (the plain
    version computes the cubic sum with the kernel's passes and rounding
    points, so the counters agree there too; their share is logged),
    beside the reading of the plain version with gamma 0.1% off;
13. the comb main path: ``nwave.solve_comb_batch`` at the full bench size at
    ``df32`` (``device`` left out), ``x32``, rk45 ``x64`` and rk45 ``x32``,
    one K4 or K5 launch each, every comb ``ok``; the 8-comb subset of
    ``bench_comb.py:338-366`` against the plain fp64 version on the CPU in
    relative power on lines above 1e-6 W (bars 1e-9, 1e-4, 1e-7, 2e-2);
    one ``run_comb_simulation`` on the card against the CPU;
14. times (median of 5 warm reps) of the four comb kernel entries and of
    ``solve_comb_batch`` end to end; the plain versions once each, in
    phases 11 and 12.  Each comb kernel's bound counts the cubic sum as two
    FFTs, the least work it needs (both kernels compute it so, through their
    own FFTs);
15. GNLSE kernel K6 (``csrc/gnlse_ssfm.cu``) vs its plain version on the
    card at the ``bench_gnlse.py`` configuration (2,048 sech envelopes of
    1,024 samples, 1,000 steps over 10 m, ``save_every=100``) with one
    envelope made to blow up and a run with a trailing partial chunk (1,005
    steps): fp64 Kerr and Raman/steepening (``nl``) within 1e-11 of each
    envelope's largest amplitude; fp32 Kerr and ``nl`` against the fp64
    plain version within 1.5e-4 (the peak 3e-4), printed beside the fp32
    plain version's own error and the plain version with gamma 0.1% off;
    equal ``ok``, the bad envelope frozen at its input;
16. GNLSE kernel K8 (``csrc/ssfm_rk45.cu``) vs its plain version on 512
    envelopes, one of them 1e12 times too strong, fp64 at rtol 1e-9/atol
    1e-12 and fp32 at 1e-5/1e-9, 1,000 and 1,005 steps: fp64 step counters
    equal on >= 99% of envelopes and results within 1e-9 there; fp32 equal
    ``ok`` and results within 1e-4, beside the plain version with gamma
    0.1% off;
17. the GNLSE main path: ``gnlse.solve_gnlse_batch`` at the full size at
    ``df32`` Kerr (``device`` left out), ``x32`` Kerr, ``df32`` ``nl``,
    ``x32`` ``nl``, rk45 ``x64`` and rk45 ``x32``, one launch each of the
    route (K6 Kerr, K6 nl, K8), every envelope ``ok``; an 8-envelope subset against the plain
    fp64 version on the CPU in relative power on the core (above 1% of the
    peak) and the tails (above 1e-6), as ``bench_gnlse.py:393-397``
    measures them (bars: df32 1e-9, x32 4.5e-3 / 2.6e-2, rk45 x64 1e-7 and
    x32 5e-4 on the core); one ``run_gnlse_simulation`` on the card against
    the CPU, and one ``engine='auto'`` rk4ip call, which runs plain torch;
18. GNLSE times (median of 5 warm reps) of the kernels (K6 Kerr and nl,
    K8) and of ``solve_gnlse_batch`` end to end, and of the same
    integrations through ``torch.fft`` (cuFFT), each route's library call
    (median of 2 for nl); the plain versions once each, in phases 15 and
    16.  The bounds count the least flop, transforms included, the Raman
    pairs as real-input transforms.  Beside K6 Kerr's time: its slotted
    Strang block (``csrc/strang.cuh``), ptxas's registers and spills, the
    blocks an SM those and its shared memory leave, and the barriers a
    Strang step, counted from the source;
19. LLE kernel K7 (``csrc/lle_ssfm.cu``) vs
    its plain version on the card at the ``bench_lle.py`` configuration
    (4,096 soliton-ansatz cavities of 256 samples, Delta in [3.6, 4.4],
    F = 2, d2 = -1, 2,000 steps of 0.01, ``save_every=200``) with one
    cavity whose |psi|^2 overflows the type (x 1e160 in fp64, 1e25 in
    fp32), a complex-pump run and a run of 2,005 steps: fp64 within 1e-11
    of each cavity's largest amplitude; fp32 against the fp64 plain version
    within 3e-4 (the peak 1e-4), printed beside the fp32 plain version's
    own error and the plain version with F 0.1% off; equal ``ok``, the bad
    cavity frozen at its input;
20. LLE kernel K8 (the affine instantiation of ``csrc/ssfm_rk45.cu``) vs
    its plain version on the first 512 cavities, one of them overflowing,
    fp64 at rtol 1e-8/atol 1e-11 and fp32 at 1e-5/1e-8, 2,000 steps and,
    in fp32, 2,005: fp64 step counters equal on >= 99% of cavities and results
    within 1e-9 there; fp32 equal ``ok`` and results within 5e-4 of the
    fp64 plain version at the same tolerance, beside the fp32 plain
    version's own error and the plain version with F 0.1% off;
21. the LLE main path: ``lle.solve_lle_batch`` at ``df32`` (``device`` left
    out), ``x32``, rk45 ``x64`` and rk45 ``x32``, and ``lle.detuning_scan``
    over 4,096 points, one K7 or K8 launch each, every cavity ``ok``; an
    8-cavity subset against the plain fp64 version on the CPU in relative
    power (``bench_lle.py:277-284``; bars 1e-9, 1e-4, 1e-7, 5e-4; the rk45
    reference is the plain fp64 rk4ip45 at rtol 1e-10, see PERF.md);
    ``run_lle_ramp`` and ``run_lle_simulation`` on the card against the
    CPU, and one ``engine='auto'`` rk4ip45 call, which runs plain torch;
22. LLE times (median of 5 warm reps) of the kernels, ``solve_lle_batch``
    end to end (instance-steps/s, cavities/s), ``detuning_scan``
    (points/s) and the same Strang integration through ``torch.fft``, K7's
    library call; K8's is its plain version's run in phase 20;
23. vector GNLSE kernel K9 (``csrc/vgnlse_ssfm.cu``) vs its plain version on
    the card at the ``bench_gnlse.py:242-276`` vector configuration (1,024
    instances of two polarizations at theta = 0.4, T = 1,024, 1,000 steps
    over 10 m, ``save_every=100``) with one instance made to blow up, each
    body: manakov (rotation), cnlse with phase and group birefringence
    (rotation), isotropic (the coherent RK4) and manakov with Raman and
    self-steepening (nl), a run with a trailing partial chunk (1,005 steps),
    and the nl body at T = 2,048 in fp64 and fp32 (256 instances): fp64
    within 1e-11 of each
    instance's largest amplitude, fp32 against the fp64 plain version within
    1e-4 (A_end and the peak), printed beside the fp32 plain version's own
    error and the plain version with gamma 0.1% off; equal ``ok``, the bad
    instance frozen at its input;
24. one empty polarization: K9 with A_y = 0 against K6 on the x parts at
    the same gamma, the rotation against Kerr (fp64 within 1e-11, fp32
    1e-5; bit for bit is logged) and the nl body against K6 nl at the same
    f_R and 1/omega_0 (1e-11, 1e-4), A_y staying 0;
25. the vector main path: ``vgnlse.solve_vgnlse_batch`` at ``df32`` manakov
    (``device`` left out), ``x32`` manakov, ``df32`` and ``x32`` isotropic,
    ``df32`` and ``x32`` manakov with nl, one launch each of the body's
    route, every instance ``ok``; an
    8-instance subset against the plain fp64 version on the CPU in relative
    power on the core and the tails (bars 1e-9, and 4.5e-3 / 2.6e-2 at
    x32); ``run_vgnlse_simulation`` and ``solve_vgnlse_batch_trajectories``
    on the card against the CPU, and one ``engine='auto'`` rk45 call, which
    runs the plain torch controller (no launch);
26. vector times (median of 5 warm reps) of K9's three bodies, of
    ``solve_vgnlse_batch`` end to end (instance-steps/s) and of the same
    Strang integration through ``torch.fft``, each body's library call
    (median of 2 for coherent and nl); beside the rotation and coherent
    bodies, their block as for K6 Kerr in phase 18.

Each main path is driven with the launch counts cleared just before it and
read just after; the SSFM sources count each route apart (K6 Kerr and nl,
K9 rotation, coherent and nl), and each route is a row of the kernels line.
The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

import ctypes
import dataclasses
import functools
import json
import re
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
# warm reps of the torch.fft integrations with the nonlinear terms or the
# coherent coupling (1.3-4.2 s a call on an H100), the library calls of the
# nl and coherent rows: fewer, for the script's run length
NL_LIB_REPS = 2
PKG = "psa_simulation_ode_rk_mvp_dispersion_tpu_torch"
JAX_PKG = "psa_simulation_ode_rk_mvp_dispersion_tpu"

# Peak rates of one H100 SXM (NVIDIA data sheet, outside the tensor cores)
# and its memory rate, for the bounds in the kernels line.
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Arithmetic per lane, counted from the sources (a fused multiply-add counts
# as two): one RHS evaluation is 111 flop.  An RK4 step is 4 RHS + 88 for
# the stage sums, then the update: 8 adds (fp64) or 32 (fp32, compensated);
# every save adds 16 (|y|^2 and the running max).  A DP45 attempt is 6 RHS
# (the first stage is the last accepted step's seventh, FSAL) + 340 for the
# stage sums (20 terms) + 102 for the error estimate (6 terms) + 69 for the
# error norm + 13 for the controller (pow counted once); each lane adds one
# RHS for its first attempt.
RHS_FLOP = 111
RK4_STEP_FLOP = {torch.float64: 4 * RHS_FLOP + 88 + 8, torch.float32: 4 * RHS_FLOP + 88 + 32}
DP45_ATTEMPT_FLOP = 6 * RHS_FLOP + 340 + 102 + 69 + 13
SAVE_FLOP = 16

RK45_TOL = {torch.float64: (1e-10, 1e-13), torch.float32: (1e-6, 1e-10)}

# The comb configuration of bench_comb.py:37-41, 94-120.
COMB_N, COMB_B, COMB_STEPS, COMB_SAVE, COMB_Z = 64, 4096, 1000, 100, 500.0
COMB_TOL = {torch.float64: (1e-9, 1e-12), torch.float32: (1e-6, 1e-10)}
# The comb kernels' bound counts the least work the function needs: the
# cubic sum through two length-L FFTs (the port's 'fft' coupling, which both
# kernels compute in their own bodies), at the peak of each type outside the
# tensor cores (PEAK_FLOPS).


def comb_rhs_flop(n, L):
    """One comb RHS: the cubic sum (two radix-2 FFTs of 5*L*log2(L) flop),
    5 per bin for F|F|^2, 7 per component for the linear terms and the
    sum."""
    return 10 * L * (L.bit_length() - 1) + 5 * L + 14 * n


def comb_step_flop(n, L, method, rdt):
    """One fixed step: its RHS evaluations, the stage sums and the update
    (compensated in float32) per component of the 2N-value state."""
    update = 4 if rdt == torch.float32 else 1
    per_component = {"rk4": 12, "ab4": 7, "abm4": 16}[method] + update
    n_rhs = {"rk4": 4, "ab4": 1, "abm4": 2}[method]
    return n_rhs * comb_rhs_flop(n, L) + 2 * n * per_component


def comb_attempt_flop(n, L):
    """One DP45 attempt: 6 RHS, 26 stage and error terms of 2 flop per
    component, and ~16 flop per line for the error norm."""
    return 6 * comb_rhs_flop(n, L) + 2 * n * 52 + 16 * n


# The GNLSE configuration of bench_gnlse.py:36-47, 109-123: sech pulses of
# T0 = 1 ps at 0.5-1.5 x the soliton power, T = 1,024 samples over 40 T0,
# 2,048 envelopes, beta2 = -2e-26 s^2/m at 1.2e15 rad/s, gamma = 2e-3 /W/m,
# alpha = 5e-5 /m, 1,000 steps over 10 m, save_every=100; Raman f_R = 0.18
# with self-steepening at omega_0 for nl; rk45 on 512 envelopes
# (bench_gnlse.py:311-317).
GN_T, GN_B, GN_B45, GN_STEPS, GN_SAVE, GN_Z = 1024, 2048, 512, 1000, 100, 10.0
GN_T0, GN_BETA2, GN_GAMMA, GN_OMEGA0, GN_ALPHA = 1e-12, -2e-26, 2e-3, 1.2e15, 5e-5
GN_TOL = {torch.float64: (1e-9, 1e-12), torch.float32: (1e-5, 1e-9)}

# The LLE configuration of bench_lle.py:38-47, 108-121, 180-200, 246-258:
# T = 256 samples over a window of 20, 4,096 cavities at Delta in
# [3.6, 4.4], F = 2, d2 = -1, soliton-ansatz seeds, 2,000 Strang steps of
# dt = 0.01, save_every=200; rk45 on the first 512 at rtol 1e-8/atol 1e-11
# (x64) and 1e-5/1e-8 (x32); the detuning scan over 4,096 points of
# [0.5, 4.5] from noisy CW seeds.
LLE_T, LLE_B, LLE_B45, LLE_STEPS, LLE_SAVE, LLE_DT = 256, 4096, 512, 2000, 200, 0.01
LLE_PUMP, LLE_D2, LLE_WINDOW = 2.0, -1.0, 20.0
LLE_TOL = {torch.float64: (1e-8, 1e-11), torch.float32: (1e-5, 1e-8)}
# a seed whose |psi|^2 overflows the type in the first Kerr substep
LLE_BAD = {torch.float64: 1e160, torch.float32: 1e25}


def fft_flop(n, inverse=False):
    """One transform of csrc/ssfm_common.cuh at width n = m * r (m a power
    of two, r odd): log2(m) radix-2 passes of n/2 butterflies (a complex
    product and two complex sums, 10 flop), an r-term complex sum per output
    when r > 1 (8 flop a term), and the inverse's 1/n (2 flop a sample)."""
    r = n
    while r % 2 == 0:
        r //= 2
    m = n // r
    return 5 * n * (m.bit_length() - 1) + (8 * n * r if r > 1 else 0) + (2 * n if inverse else 0)


def gnlse_step_flop(n, nl):
    """The least work of one K6 step, as ``(transform flop, pointwise
    flop)``: a linear substep (two transforms and a 6-flop factor product a
    sample) and the nonlinear one: the Kerr rotation (13 a sample, sin and
    cos one each) or an RK4 on N (four evaluations of a steepening transform
    pair and a Raman pair, 30 flop a sample, and 24 a sample for the stage
    sums).  The Raman pair transforms the real power into a real response,
    which real-input transforms do at half a complex pair's cost; the
    kernel transforms it as complex."""
    pair = fft_flop(n) + fft_flop(n, True)
    if not nl:
        return pair, 6 * n + 13 * n
    return pair + 4 * 1.5 * pair, 6 * n + 4 * 30 * n + 24 * n


def ssfm_attempt_flop(n):
    """One K8 attempt, counted from csrc/ssfm_rk45.cu, as ``(transform flop,
    pointwise flop)``: 4 forward and 5 inverse transforms; the factor build
    (11 a sample), five factor products (6), three Kerr rotations (13), the
    three norms (12) and the candidate with its norm (9)."""
    return 4 * fft_flop(n) + 5 * fft_flop(n, True), (11 + 30 + 39 + 12 + 9) * n


def strang_layout(_build, source, n, P, rdt, op=None):
    """The launched block of a slotted Strang kernel (``csrc/strang.cuh``: K6
    Kerr, K9 rotation and coherent) at width n with P sequences, as one
    line: its threads, samples a thread and passes a transform, read from
    the library (``<source>_strang_block``, the function its launcher takes
    them from); ptxas's registers and spills of that instantiation
    (``gnlse_ssfm_kernel<T, S>``, or ``vgnlse_ssfm_kernel<T, op<T>, S>``),
    found by its mangled name; the blocks an SM those registers and the
    block's shared memory leave (H100: 65,536 registers, 233,472 bytes of
    shared memory with 1,024 reserved a block, 2,048 threads, 32 blocks);
    and the barriers a Strang step, one a pass of each transform."""
    fn = getattr(_build.load_library(source), f"{source}_strang_block")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    slots, passes = ctypes.c_int(), ctypes.c_int()
    nt = fn(n, ctypes.byref(slots), ctypes.byref(passes))
    S, passes = slots.value, passes.value
    t = "d" if rdt == torch.float64 else "f"
    if op is None:
        entry = (f"{len(source) + 7}{source}_kernelI{t}Li{S}EEEv",)
    else:   # the body is a class of the same anonymous namespace (NS_)
        entry = (f"{len(source) + 7}{source}_kernelI{t}NS_{len(op)}{op}I{t}EELi{S}EEEv",)
    regs = spill = None
    lines = _build.build_log().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and all(e in line for e in entry):
            for info in lines[i + 1:i + 6]:
                if "Compiling entry" in info:
                    break
                m = re.search(r"Used (\d+) registers", info)
                regs = int(m.group(1)) if m else regs
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
                spill = (int(m.group(1)), int(m.group(2))) if m else spill
            break
    if regs is None:
        raise AssertionError(f"no ptxas entry of the launched instance {entry} in the build log")
    smem = torch.finfo(rdt).bits // 8 * (32 + 4 * P * n)
    blocks = min(233_472 // (smem + 1024), 2048 // nt, 32,
                 65_536 // (-(-regs // 8) * 8 * nt))
    return (f"block: {S} samples a thread{' of each polarization' if P == 2 else ''}, {nt} "
            f"threads, {regs} registers, spill stores/loads {spill} bytes, {blocks} blocks an "
            f"SM (from the registers and {smem} bytes of shared memory), {2 * passes} barriers "
            f"a Strang step ({passes} passes a transform)")


def fwm4_layout(_build, source, B, rdt):
    """The launch of a 4-wave kernel (``csrc/fwm4_rk.cu`` rk4, or
    ``csrc/fwm4_rk45.cu``) at B lanes, as one line: the threads a lane G (one
    for K1/K2; for K3 the launcher's pick, ``fwm4_rk45_group``), ptxas's
    registers and spills of that instantiation (``fwm4_rk_kernel<T, 0>``
    or ``fwm4_rk45_kernel<T, G>``, found by its mangled name), the warps the
    launch makes, and the warps resident at once (128-thread blocks; an SM
    holds as many as its 65,536 registers, 2,048 threads and 32 blocks
    allow)."""
    G = 1
    if source == "fwm4_rk45":
        fn = _build.load_library(source).fwm4_rk45_group
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        G = fn(B)
    t = "d" if rdt == torch.float64 else "f"
    args = f"I{t}Li0EE" if source == "fwm4_rk" else f"I{t}Li{G}EE"
    entry = f"{len(source) + 7}{source}_kernel{args}Ev"
    regs = spill = None
    lines = _build.build_log().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and entry in line:
            for info in lines[i + 1:i + 6]:
                if "Compiling entry" in info:
                    break
                m = re.search(r"Used (\d+) registers", info)
                regs = int(m.group(1)) if m else regs
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
                spill = (int(m.group(1)), int(m.group(2))) if m else spill
            break
    if regs is None:
        raise AssertionError(f"no ptxas entry of the launched instance {entry} in the build log")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = min(2048 // 128, 32, 65_536 // (-(-regs // 8) * 8 * 128))
    warps = -(-B * G // 32)
    return (f"G = {G} threads a lane, {regs} registers, spill stores/loads {spill} bytes; "
            f"{warps} warps in {-(-B * G // 128)} blocks of 128 threads, "
            f"{min(warps, 4 * sms * per_sm)} resident at once ({per_sm} blocks an SM, {sms} SMs)")


def ops_ms(flop, rdt):
    """The least time of ``flop`` operations, at the peak of the kernel's
    type.  The fp32 kernels transform in double (csrc/ssfm_common.cuh) for
    accuracy; their function needs only float32, so the bound counts it."""
    return 1e3 * flop / PEAK_FLOPS[rdt]


def gnlse_setup(psa, precision, nl=False, B=None):
    """Host ``(A0 (B, T), coeffs, nl terms or None)`` of the bench
    configuration at ``precision`` (B: the bench's 2,048)."""
    B = GN_B if B is None else B
    gn = psa.gnlse
    grid = gn.TimeGrid.for_pulse(GN_T0, n_samples=GN_T)
    co = gn.make_gnlse_coeffs(grid, psa.DispersionParams.from_betas(GN_OMEGA0, beta2=GN_BETA2),
                              gamma_W_m=GN_GAMMA, alpha_1_m=GN_ALPHA, precision=precision)
    terms = (gn.make_nl_terms(grid, f_raman=0.18, omega0=GN_OMEGA0, precision=precision)
             if nl else None)
    P0 = gn.soliton_peak_power(GN_BETA2, GN_GAMMA, GN_T0)
    A0 = np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None] / np.cosh(grid.t()[None, :] / GN_T0)
    return A0.astype(np.complex128), co, terms


def gnlse_lanes(psa, rdt, dev, B=None, nl=False, bad_alpha=None, bad_scale=None):
    """Kernel inputs ``(A0, gamma, alpha, lin_phase)`` and nl terms on the
    card; envelope B//2 has the loss ``bad_alpha`` (a gain that overflows
    within the first chunk) or starts ``bad_scale`` times too strong."""
    B = GN_B if B is None else B
    A0, co, terms = gnlse_setup(psa, "x64", nl, B)
    if bad_scale is not None:
        A0[B // 2] *= bad_scale
    t = psa.gnlse.lane_coeffs(co, B, GN_T, rdt, dev)
    if bad_alpha is not None:
        t[1][B // 2] = bad_alpha
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    nl_t = psa.gnlse._cast_nl(terms, rdt, dev)
    return (torch.as_tensor(A0, device=dev).to(cdt),) + t, nl_t


def power_errors(A, A_ref):
    """bench_gnlse.py:393-397: the largest relative power error on the core
    (samples above 1% of the peak) and on the tails (above 1e-6)."""
    P, P_ref = np.abs(A) ** 2, np.abs(A_ref) ** 2
    rel = np.abs(P / np.maximum(P_ref, 1e-300) - 1.0)
    return (float(rel[P_ref > 1e-2 * P_ref.max()].max()),
            float(rel[P_ref > 1e-6 * P_ref.max()].max()))


def check_gnlse_kernel(psa, cg, dev, max_err, plain_ms):
    """Phase 15: gnlse_ssfm.cu against its plain version at the bench size
    with a blown-up envelope; the plain version's 1,000-step run of each
    case is its time.  The fp32 kernel and the fp32 plain version round
    their transforms differently (the kernel in double with the float64
    twiddles, cuFFT in float32), so each is held against the fp64 plain
    version of the same case."""
    B, bad = GN_B, GN_B // 2
    cases = [(torch.float64, False, GN_STEPS), (torch.float64, False, GN_STEPS + 5),
             (torch.float64, True, GN_STEPS), (torch.float32, False, GN_STEPS),
             (torch.float32, True, GN_STEPS)]
    ref64 = {}
    for rdt, nl, n_steps in cases:
        t, nl_t = gnlse_lanes(psa, rdt, dev, nl=nl, bad_alpha=-4e6)
        kw = dict(dz_m=GN_Z / GN_STEPS, n_steps=n_steps, save_every=GN_SAVE, nl=nl_t)
        rk = cg.solve_gnlse_batch_cuda(*t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = cg.solve_gnlse_batch_torch(*t, **kw)
        torch.cuda.synchronize()
        key = f"gnlse_ssfm{'_nl' if nl else ''}_{suffix(rdt)}"
        if n_steps == GN_STEPS:
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
            if rdt == torch.float64:
                ref64[nl] = rp
        label = (f"gnlse kernel vs plain {str(rdt)[6:]} {'nl' if nl else 'kerr'} B={B} "
                 f"n_steps={n_steps}")
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{label}: expected exactly envelope {bad} to fail")
        if not (bool(torch.isfinite(rk.A_end).all()) and torch.equal(rk.A_end[bad], t[0][bad])):
            raise AssertionError(f"{label}: the failed envelope is not frozen at its input")
        good = rk.ok
        err_A = normwise(rk.A_end[good], rp.A_end[good])
        err_pk = float(rel_err(rk.peak_max[good], rp.peak_max[good]).max())
        max_err[key] = max(max_err.get(key, 0.0), float((rk.A_end[good] - rp.A_end[good])
                                                        .abs().max()))
        if rdt == torch.float64:
            log(f"{label}: A_end max normwise err {err_A:.3e}, peak max rel err {err_pk:.3e} "
                "(bar 1e-11); bad envelope frozen at its input")
            if not (err_A <= 1e-11 and err_pk <= 1e-11):
                raise AssertionError(f"{label}: {err_A:.3e} / {err_pk:.3e} > 1e-11")
            continue
        # fp32: against the fp64 plain version; the bars are half what a
        # 0.1% error in gamma reads in A_end and 3e-4 in the peak, which that
        # error barely moves (PERF.md section 6)
        ref = ref64[nl]
        up = (lambda r: (r.A_end[good].to(torch.complex128), r.peak_max[good].double()))
        (kA, kp), (pA, pp) = up(rk), up(rp)
        ek_A, ek_pk = normwise(kA, ref.A_end[good]), float(rel_err(kp, ref.peak_max[good]).max())
        ep_A, ep_pk = normwise(pA, ref.A_end[good]), float(rel_err(pp, ref.peak_max[good]).max())
        log(f"{label}: kernel vs plain fp64 A_end {ek_A:.3e} (bar 1.5e-4), peak {ek_pk:.3e} "
            f"(bar 3e-4); plain fp32 (cuFFT) vs plain fp64 A_end {ep_A:.3e}, peak {ep_pk:.3e}; "
            f"kernel vs plain fp32 A_end {err_A:.3e}, peak {err_pk:.3e}; bad envelope frozen")
        if not nl:
            # what a wrong kernel would read: the plain version with every
            # gamma 0.1% off
            off = cg.solve_gnlse_batch_torch(t[0], t[1] * (1 + 1e-3), *t[2:], **kw)
            log(f"{label}: the plain fp32 version with gamma 0.1% off reads A_end "
                f"{normwise(off.A_end[good], rp.A_end[good]):.3e}, peak "
                f"{float(rel_err(off.peak_max[good], rp.peak_max[good]).max()):.3e}")
        if not (ek_A <= 1.5e-4 and ek_pk <= 3e-4):
            raise AssertionError(f"{label}: {ek_A:.3e} / {ek_pk:.3e} against fp64 over the bars")


def check_ssfm_rk45_kernel(psa, csa, dev, max_err, plain_ms, steps):
    """Phase 16: ssfm_rk45.cu against its plain version on 512 envelopes,
    one of them 1e12 times too strong (its Kerr phase drives the controller
    to dt_min at once); the plain version's 1,000-step run is its time."""
    B, bad = GN_B45, GN_B45 // 2
    for rdt, n_steps in ((torch.float64, GN_STEPS), (torch.float64, GN_STEPS + 5),
                         (torch.float32, GN_STEPS)):
        rtol, atol = GN_TOL[rdt]
        t, _ = gnlse_lanes(psa, rdt, dev, B=B, bad_scale=1e12)
        kw = dict(dz_m=GN_Z / GN_STEPS, n_steps=n_steps, save_every=GN_SAVE, rtol=rtol,
                  atol=atol, max_steps=20_000)
        rk = csa.solve_gnlse_batch_rk45_cuda(*t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = csa.solve_gnlse_batch_rk45_torch(*t, **kw)
        torch.cuda.synchronize()
        key = f"ssfm_rk45_{suffix(rdt)}"
        label = f"ssfm rk45 kernel vs plain {str(rdt)[6:]} B={B} n_steps={n_steps}"
        if key not in plain_ms:
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
            attempts = (rk.n_accepted + rk.n_rejected)[rk.ok].double()
            steps[key] = (float(attempts.mean()), int(attempts.max()))
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{label}: expected exactly envelope {bad} to fail")
        if not bool(torch.isfinite(rk.A_end).all()):
            raise AssertionError(f"{label}: non-finite kernel output")
        good = rk.ok
        same = good & (rk.n_accepted == rp.n_accepted) & (rk.n_rejected == rp.n_rejected)
        share = float(same.double().sum() / good.double().sum())
        err_all = normwise(rk.A_end[good], rp.A_end[good])
        err_same = normwise(rk.A_end[same], rp.A_end[same]) if bool(same.any()) else 0.0
        err_pk = float(rel_err(rk.peak_max[good], rp.peak_max[good]).max())
        max_err[key] = max(max_err.get(key, 0.0), float((rk.A_end[good] - rp.A_end[good])
                                                        .abs().max()))
        log(f"{label}: A_end max normwise err {err_all:.3e} (all envelopes), {err_same:.3e} "
            f"(equal counters), peak {err_pk:.3e}; counters equal on {share:.4f}")
        if rdt == torch.float64:
            bars = ((share, 0.99, "share of equal counters", True),
                    (err_same, 1e-9, "envelopes with equal counters", False))
        else:
            bars = ((err_all, 1e-4, "all envelopes", False), (err_pk, 1e-4, "peak", False))
        for val, bar, where, at_least in bars:
            if not (val >= bar if at_least else val <= bar):
                raise AssertionError(f"{label}: {val:.3e} against {bar:g} on {where}")
        if rdt == torch.float32:
            # what a wrong kernel would read against the 1e-4 bar: the plain
            # version with every gamma 0.1% off
            off = csa.solve_gnlse_batch_rk45_torch(t[0], t[1] * (1 + 1e-3), *t[2:], **kw)
            g2 = good & off.ok
            log(f"{label} A_end: the plain version with gamma 0.1% off reads "
                f"{normwise(rk.A_end[g2], off.A_end[g2]):.3e} (bar 1e-4)")


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


def cfg_for(psa, precision, **kw):
    return psa.custom_simulation_config(z_max=500.0, dz=0.2, save_every=10, precision=precision,
                                        **kw)


def cfg45_for(psa, precision, rtol=None, atol=None):
    """The bench's adaptive lane (bench.py:323-348): rk45 over the same
    grid; fp64 tiers at rtol 1e-10/atol 1e-13, x32 at 1e-6/1e-10."""
    rdt = torch.float32 if precision == "x32" else torch.float64
    r, a = RK45_TOL[rdt]
    return cfg_for(psa, precision, integrator="rk45", rtol=rtol or r, atol=atol or a)


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


def rel_err(k, p):
    """Elementwise |k - p| / |p| (0 where both are 0)."""
    return (k - p).abs() / p.abs().clamp_min(torch.finfo(p.real.dtype).tiny)


def max_rel(a, b):
    """max |a - b| / |b| over host arrays (0 where both are 0)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), np.finfo(float).tiny)))


def suffix(rdt):
    return "f64" if rdt == torch.float64 else "f32"


def with_bad_lane(t, bad):
    A0, g, a, db = t
    A0[bad] = torch.tensor([1e4, 1e4, 1.0, 0.0], dtype=A0.dtype)
    g[bad] = 1e3                                   # this lane must blow up
    return A0, g, a, db


def check_fixed_kernel(psa, cs, common, dev, max_err, plain_ms):
    """Phase 3: fwm4_rk.cu against its plain version at 10^4 lanes.  The
    plain version's run of rk4 over 2,500 steps, after a run of the same
    ops over 2,497 steps, is its time."""
    B, bad = N_POINTS, N_POINTS // 2
    cases = [(torch.float64, "rk4", 2497)]
    cases += [(torch.float64, m, 2500) for m in ("rk4", "ab4", "abm4")]
    cases += [(torch.float32, "rk4", 2497), (torch.float32, "rk4", 2500)]
    for rdt, method, n_steps in cases:
        t = with_bad_lane(lanes(psa, common, B, rdt, dev), bad)
        kw = dict(dz_m=0.2, n_steps=n_steps, save_every=10, integrator=method)
        rk = cs.solve_batch_cuda(*t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = cs.solve_batch_torch(*t, **kw)
        torch.cuda.synchronize()
        if (method, n_steps) == ("rk4", 2500):
            plain_ms[f"fwm4_rk_{suffix(rdt)}"] = 1e3 * (time.perf_counter() - t0)
        rtol = 1e-11 if rdt == torch.float64 else 1e-4
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{method} {rdt} n={n_steps}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{method} {rdt}: expected exactly lane {bad} to fail")
        for name, k, p in (("P_max", rk.P_max, rp.P_max), ("A_end", rk.A_end, rp.A_end)):
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"{method} {rdt} {name}: non-finite kernel output")
            rel = float(rel_err(k, p).max())
            key = f"fwm4_rk_{suffix(rdt)}"
            max_err[key] = max(max_err.get(key, 0.0), float((k - p).abs().max()))
            log(f"kernel vs plain {str(rdt)[6:]} {method} B={B} n_steps={n_steps} {name}: "
                f"max rel err {rel:.3e} (bar {rtol:g})")
            if not rel <= rtol:
                raise AssertionError(f"{method} {rdt} {name}: {rel:.3e} > {rtol:g}")


def check_rk45_kernel(psa, ca, common, dev, max_err, plain_ms, steps):
    """Phase 4: fwm4_rk45.cu against its plain version at 10^4 lanes over
    100 m (the plain loop runs once per attempt of the slowest lane, ~75 s
    in fp64 over the full 500 m).  The plain version's single run in the
    first case of each dtype is its time."""
    B, bad = N_POINTS, N_POINTS // 2
    cases = [(torch.float64, 500, 10), (torch.float32, 497, 10), (torch.float32, 500, 7)]
    for rdt, n_steps, save_every in cases:
        rtol, atol = RK45_TOL[rdt]
        t = with_bad_lane(lanes(psa, common, B, rdt, dev), bad)
        kw = dict(dz_m=0.2, n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol)
        rk = ca.solve_batch_rk45_cuda(*t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = ca.solve_batch_rk45_torch(*t, **kw)
        torch.cuda.synchronize()
        key = f"fwm4_rk45_{suffix(rdt)}"
        label = f"rk45 kernel vs plain {str(rdt)[6:]} B={B} n_steps={n_steps} save_every={save_every}"
        if key not in plain_ms:
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
            attempts = (rk.n_accepted + rk.n_rejected).double()
            steps[key] = (float(attempts.mean()), int(attempts.max()))
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{label}: expected exactly lane {bad} to fail")
        same = (rk.n_accepted == rp.n_accepted) & (rk.n_rejected == rp.n_rejected)
        share = float(same.double().mean())
        if share < 0.99:
            raise AssertionError(f"{label}: step counters agree on {share:.4f} < 0.99 of lanes")
        for name, k, p in (("P_max", rk.P_max, rp.P_max), ("A_end", rk.A_end, rp.A_end)):
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"{label} {name}: non-finite kernel output")
            rel = rel_err(k, p)
            rel_all = float(rel.max())
            rel_same = float(rel[same].max())
            max_err[key] = max(max_err.get(key, 0.0), float((k - p).abs().max()))
            if rdt == torch.float64:
                bars = ((rel_same, 1e-11, "lanes with equal counters"),
                        (rel_all, 10 * rtol, "all lanes"))
            else:
                bars = ((rel_all, 1e-4, "all lanes"),)
            log(f"{label} {name}: max rel err {rel_all:.3e} (all lanes), {rel_same:.3e} "
                f"(lanes with equal counters); counters equal on {share:.4f}; bit-identical "
                f"{bool(torch.equal(k, p))}")
            for val, bar, where in bars:
                if not val <= bar:
                    raise AssertionError(f"{label} {name}: {val:.3e} > {bar:g} on {where}")


def comb_setup(psa):
    """bench_comb.py's comb: two 0.5 W pumps at c +- 8, a 1e-9 W noise floor
    (seed 0), beta2 = -1e-27 s^2/m and beta3 = 1.2e-41 s^3/m at 193.1 THz,
    50 GHz spacing, over a gamma grid of 4,096 values in [5e-3, 15e-3].
    Returns host ``(A0 (B, N), coeffs)``."""
    nw = psa.nwave
    omega_c = 2.0 * np.pi * 193.1e12
    grid = nw.CombGrid.centered(omega_c, 2.0 * np.pi * 50e9, COMB_N)
    disp = psa.DispersionParams.from_betas(omega_c, beta2=-1.0e-27, beta3=1.2e-41)
    beta = nw.comb_beta_lin(grid, disp)
    c = COMB_N // 2
    A0 = nw.seed_comb(grid, pump_lines={c - 8: 0.5, c + 8: 0.5}, noise_floor_W=1e-9, seed=0)
    coeffs = nw.NWaveCoeffs(gamma=np.linspace(5e-3, 15e-3, COMB_B),
                            alpha=np.full(COMB_B, 5e-5), beta_lin=beta)
    return np.broadcast_to(A0, (COMB_B, COMB_N)).copy(), coeffs


def comb_lanes(psa, rdt, dev, bad=None):
    """The kernel inputs of comb_setup as tensors; comb ``bad`` blows up."""
    A0, co = comb_setup(psa)
    g = co.gamma.copy()
    if bad is not None:
        A0[bad] *= 1e3
        g[bad] = 1e3
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    full = dict(dtype=rdt, device=dev)
    return (torch.as_tensor(A0, dtype=cdt, device=dev), torch.as_tensor(g, **full),
            torch.as_tensor(co.alpha, **full),
            torch.as_tensor(np.broadcast_to(co.beta_lin, (COMB_B, COMB_N)).copy(), **full))


def comb_cfg(psa, precision, integrator="rk4", rtol=None, atol=None):
    rdt = torch.float32 if precision == "x32" else torch.float64
    r, a = COMB_TOL[rdt]
    return psa.custom_simulation_config(
        z_max=COMB_Z, dz=COMB_Z / COMB_STEPS, save_every=COMB_SAVE, precision=precision,
        integrator=integrator, rtol=rtol or r, atol=atol or a)


def normwise(k, p):
    """Worst over combs of max_lines |k - p| / max_lines |p|."""
    return float(((k - p).abs().amax(-1) / p.abs().amax(-1).clamp_min(1e-300)).max())


def check_comb_kernel(psa, cc, dev, max_err, plain_ms):
    """Phase 11: comb_rk.cu against its plain version at the bench size.
    The plain version's rk4 run at 1,000 steps of each dtype is its time;
    the other runs take half the steps (the plain version's time follows
    them)."""
    bad = COMB_B // 2
    half = COMB_STEPS // 2
    cases = [(torch.float64, "rk4", COMB_STEPS), (torch.float64, "ab4", half),
             (torch.float64, "abm4", half), (torch.float64, "rk4", half + 5),
             (torch.float32, "rk4", COMB_STEPS)]
    for rdt, method, n_steps in cases:
        t = comb_lanes(psa, rdt, dev, bad)
        kw = dict(dz_m=COMB_Z / COMB_STEPS, n_steps=n_steps, save_every=COMB_SAVE,
                  integrator=method)
        rk = cc.solve_comb_batch_cuda(*t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = cc.solve_comb_batch_torch(*t, **kw)
        torch.cuda.synchronize()
        key = f"comb_rk_{suffix(rdt)}"
        if (method, n_steps) == ("rk4", COMB_STEPS):
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
        bar = 1e-11 if rdt == torch.float64 else 1e-4
        label = f"comb kernel vs plain {str(rdt)[6:]} {method} B={COMB_B} n_steps={n_steps}"
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != COMB_B - 1:
            raise AssertionError(f"{label}: expected exactly comb {bad} to fail")
        for name, k, p in (("P_max", rk.P_max, rp.P_max), ("A_end", rk.A_end, rp.A_end)):
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"{label} {name}: non-finite kernel output")
            err = normwise(k, p)
            max_err[key] = max(max_err.get(key, 0.0), float((k - p).abs().max()))
            log(f"{label} {name}: max normwise err {err:.3e} (bar {bar:g})")
            if not err <= bar:
                raise AssertionError(f"{label} {name}: {err:.3e} > {bar:g}")


def check_comb_rk45_kernel(psa, cca, dev, max_err, plain_ms, steps):
    """Phase 12: comb_rk45.cu against its plain version at the bench size.
    The plain version's run at 1,000 steps of each dtype is its time."""
    bad = COMB_B // 2
    for rdt, n_steps in ((torch.float64, COMB_STEPS), (torch.float64, COMB_STEPS // 2 + 5),
                         (torch.float32, COMB_STEPS)):
        rtol, atol = COMB_TOL[rdt]
        t = comb_lanes(psa, rdt, dev, bad)
        kw = dict(dz_m=COMB_Z / COMB_STEPS, n_steps=n_steps, save_every=COMB_SAVE, rtol=rtol,
                  atol=atol)
        rk = cca.solve_comb_batch_rk45_cuda(*t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = cca.solve_comb_batch_rk45_torch(*t, **kw)
        torch.cuda.synchronize()
        key = f"comb_rk45_{suffix(rdt)}"
        label = f"comb rk45 kernel vs plain {str(rdt)[6:]} B={COMB_B} n_steps={n_steps}"
        if key not in plain_ms:
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
            attempts = (rk.n_accepted + rk.n_rejected).double()
            steps[key] = (float(attempts.mean()), int(attempts.max()))
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != COMB_B - 1:
            raise AssertionError(f"{label}: expected exactly comb {bad} to fail")
        same = (rk.n_accepted == rp.n_accepted) & (rk.n_rejected == rp.n_rejected)
        share = float(same.double().mean())
        if rdt == torch.float64 and share < 0.99:
            raise AssertionError(f"{label}: step counters agree on {share:.4f} < 0.99 of combs")
        for name, k, p in (("P_max", rk.P_max, rp.P_max), ("A_end", rk.A_end, rp.A_end)):
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"{label} {name}: non-finite kernel output")
            err_all = normwise(k, p)
            err_same = normwise(k[same], p[same]) if bool(same.any()) else 0.0
            max_err[key] = max(max_err.get(key, 0.0), float((k - p).abs().max()))
            if rdt == torch.float64:
                bars = ((err_same, 1e-9, "combs with equal counters"),
                        (err_all, 10 * rtol, "all combs"))
            else:
                # the card test's bar: the steps differ, so the results
                # differ by the controller's tolerance, not by rounding
                bars = ((err_all, 1e-3, "all combs"),)
            log(f"{label} {name}: max normwise err {err_all:.3e} (all combs), {err_same:.3e} "
                f"(combs with equal counters); counters equal on {share:.4f}")
            for val, bar, where in bars:
                if not val <= bar:
                    raise AssertionError(f"{label} {name}: {val:.3e} > {bar:g} on {where}")
        if rdt == torch.float32:
            # what a wrong kernel would read against the 1e-3 bar: the plain
            # version with every gamma 0.1% off
            off = cca.solve_comb_batch_rk45_torch(t[0], t[1] * (1 + 1e-3), *t[2:], **kw)
            good = rk.ok & off.ok
            log(f"{label} A_end: the plain version with gamma 0.1% off reads "
                f"{normwise(rk.A_end[good], off.A_end[good]):.3e} (bar 1e-3)")


def run_main_path(psa, _build, name, fn):
    """Drive one main path with the launch counts cleared just before and
    read just after; return (result, counts)."""
    _build.LAUNCHES.clear()
    res = fn()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    if counts.get(name, 0) < 1:
        raise AssertionError(f"the path did not launch {name}: {counts}")
    return res, counts


def check_spectrum(res, precision):
    ok_frac = float(res.ok.mean())
    if res.gain.shape != (N_POINTS,) or ok_frac < 0.99:
        raise AssertionError(f"{precision}: bad result (shape {res.gain.shape}, ok {ok_frac})")
    if not np.isfinite(res.gain[res.ok]).all():
        raise AssertionError(f"{precision}: non-finite gain on ok points")
    return ok_frac


def gnlse_phases(psa, _build, cg, csa, dev, card, t_start, rec):
    """Phases 15-18, the GNLSE path; ``rec`` holds the records the kernels
    line is made of."""
    max_err, plain_ms, steps, launches = (rec[k] for k in ("max_err", "plain_ms", "steps",
                                                           "launches"))
    ms, bound_ms, bound_by, bytes_of = (rec[k] for k in ("ms", "bound_ms", "bound_by",
                                                         "bytes_of"))
    # --- 15. GNLSE kernel K6 vs plain version --------------------------------------
    check_gnlse_kernel(psa, cg, dev, max_err, plain_ms)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 15 done")

    # --- 16. GNLSE kernel K8 vs plain version --------------------------------------
    check_ssfm_rk45_kernel(psa, csa, dev, max_err, plain_ms, steps)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 16 done")

    # --- 17. the GNLSE main path ---------------------------------------------------
    gn = psa.gnlse
    gn_sub = np.linspace(0, GN_B - 1, 8).astype(int)
    gn_sub45 = np.linspace(0, GN_B45 - 1, 8).astype(int)
    gn_paths = (("df32", "rk4", False, "gnlse_ssfm_f64", 1e-9, 1e-9),
                ("x32", "rk4", False, "gnlse_ssfm_f32", 4.5e-3, 2.6e-2),
                ("df32", "rk4", True, "gnlse_ssfm_nl_f64", 1e-9, 1e-9),
                ("x32", "rk4", True, "gnlse_ssfm_nl_f32", 4.5e-3, 2.6e-2),
                ("x64", "rk45", False, "ssfm_rk45_f64", 1e-7, None),
                ("x32", "rk45", False, "ssfm_rk45_f32", 5e-4, None))

    def gn_cfg(precision, integrator):
        rdt = torch.float32 if precision == "x32" else torch.float64
        r, a = GN_TOL[rdt]
        return psa.custom_simulation_config(z_max=GN_Z, dz=GN_Z / GN_STEPS, save_every=GN_SAVE,
                                            precision=precision, integrator=integrator,
                                            rtol=r, atol=a)

    gn_refs = {}
    for precision, integ, nl, name, core_bar, tail_bar in gn_paths:
        B = GN_B45 if integ == "rk45" else GN_B
        sub = gn_sub45 if integ == "rk45" else gn_sub
        A0g, cog, nlg = gnlse_setup(psa, precision, nl, B)
        # the first call leaves the device out: the card is the default
        dev_kw = {} if name == "gnlse_ssfm_f64" and not nl else {"device": "cuda"}
        t0 = time.perf_counter()
        (pk, A, ok), counts = run_main_path(psa, _build, name, lambda: gn.solve_gnlse_batch(
            gn_cfg(precision, integ), cog, A0g, nl=nlg, engine="auto", **dev_kw))
        sec = time.perf_counter() - t0
        if counts != {name: 1}:
            raise AssertionError(f"gnlse {precision} {integ}: launches {counts}, not one {name}")
        launches[name] = launches.get(name, 0) + counts[name]
        if A.shape != (B, GN_T) or not ok.all() or not np.isfinite(A).all():
            raise AssertionError(f"gnlse {precision} {integ}: shape {A.shape}, ok {ok.mean()}")
        key = (integ, nl, B)
        if key not in gn_refs:
            A0r, cor, nlr = gnlse_setup(psa, "x64", nl, B)
            ref_cfg = psa.custom_simulation_config(
                z_max=GN_Z, dz=GN_Z / GN_STEPS, save_every=GN_SAVE, integrator=integ,
                rtol=1e-11, atol=1e-14)
            t1 = time.perf_counter()
            gn_refs[key] = gn.solve_gnlse_batch(ref_cfg, cor, A0r[sub], nl=nlr,
                                                engine="torch", device="cpu")[1]
            log(f"plain fp64 {integ}{' nl' if nl else ''} reference on the CPU, 8 envelopes"
                f"{' at rtol 1e-11' if integ == 'rk45' else ''}: "
                f"{time.perf_counter() - t1:.1f} s")
        core, tails = power_errors(A[sub], gn_refs[key])
        log(f"main path gnlse {integ} {precision}{' nl' if nl else ''}: {B} envelopes of "
            f"{GN_T} samples, launches {counts}, ok 1.0, {sec * 1e3:.1f} ms (first call); "
            f"8-envelope subset vs plain fp64 (CPU): max rel power err {core:.3e} on the core "
            f"(bar {core_bar:g}), {tails:.3e} on the tails"
            f"{f' (bar {tail_bar:g})' if tail_bar else ''}")
        if not (core <= core_bar and (tail_bar is None or tails <= tail_bar)):
            raise AssertionError(f"gnlse {precision} {integ} subset error {core:.3e} / "
                                 f"{tails:.3e}")

    A0s, cos_, nls = gnlse_setup(psa, "x64", True, 1)
    run_cfg = psa.custom_simulation_config(z_max=GN_Z, dz=GN_Z / GN_STEPS, save_every=GN_SAVE)
    t0 = time.perf_counter()
    z, A = gn.run_gnlse_simulation(run_cfg, cos_, A0s[0], nl=nls, device="cuda")
    sec = time.perf_counter() - t0
    z_c, A_c = gn.run_gnlse_simulation(run_cfg, cos_, A0s[0], nl=nls, device="cpu")
    err = float(np.max(np.abs(A - A_c)) / np.max(np.abs(A_c)))
    log(f"run_gnlse_simulation on the card (1,000 Strang steps with Raman and steepening, "
        f"plain torch): {A.shape[0]} rows in {sec:.1f} s; vs the CPU {err:.3e} of the largest "
        "amplitude (bar 1e-11)")
    if not (A.shape == (GN_STEPS // GN_SAVE + 1, GN_T) and np.array_equal(z, z_c)
            and err <= 1e-11):
        raise AssertionError(f"run_gnlse_simulation: shape {A.shape}, error {err:.3e}")
    A0g, cog, _ = gnlse_setup(psa, "x64", False, 64)
    _build.LAUNCHES.clear()
    _pk, A_ip, ok_ip = gn.solve_gnlse_batch(gn_cfg("x64", "rk4ip"), cog, A0g, device="cuda")
    torch.cuda.synchronize()
    log(f"solve_gnlse_batch rk4ip (engine='auto', 64 envelopes): launches "
        f"{dict(_build.LAUNCHES)} (plain torch, as the JAX package's 'auto'), ok {ok_ip.mean()}")
    if _build.LAUNCHES or not ok_ip.all():
        raise AssertionError(f"rk4ip auto: launches {dict(_build.LAUNCHES)}, ok {ok_ip.mean()}")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 17 done")

    # --- 18. GNLSE times -----------------------------------------------------------
    gn_kw = dict(dz_m=GN_Z / GN_STEPS, n_steps=GN_STEPS, save_every=GN_SAVE)
    n_saves = GN_STEPS // GN_SAVE
    gn_flop, library_ms = {}, rec["library_ms"]

    def gn_bound(name, t_ops, nbytes):
        t_bytes = 1e3 * nbytes / PEAK_BYTES
        bound_ms[name] = max(t_ops, t_bytes)
        bound_by[name] = "operations" if t_ops >= t_bytes else "bytes"
        bytes_of[name] = nbytes

    for rdt in (torch.float64, torch.float32):
        item = rdt.itemsize
        # inputs: A0, the two shared factor rows, gamma, the float64
        # twiddles (nl: conj(H_R), omega); outputs: the peak, A_end, ok
        nbytes = GN_B * (2 * GN_T * item * 2 + 2 * item + 1) + (2 * 2 * item + 16) * GN_T
        for nl in (False, True):
            name = f"gnlse_ssfm{'_nl' if nl else ''}_{suffix(rdt)}"
            t, nl_t = gnlse_lanes(psa, rdt, dev, nl=nl)
            ms[name] = 1e3 * timed(lambda: cg.solve_gnlse_batch_cuda(*t, **gn_kw, nl=nl_t))
            # a chunk of k steps makes k + 1 linear substeps; each save adds
            # the finite check and the peak
            tr, pw = gnlse_step_flop(GN_T, nl)
            tr = GN_B * (GN_STEPS * tr + n_saves * (fft_flop(GN_T) + fft_flop(GN_T, True)))
            pw = GN_B * (GN_STEPS * pw + n_saves * 12 * GN_T)
            gn_flop[name] = tr + pw
            gn_bound(name, ops_ms(tr + pw, rdt), nbytes + (3 * GN_T * item if nl else 0))
            # the same Strang integration through torch.fft (cuFFT) on the card;
            # the nl one with fewer reps (seconds a call)
            library_ms[name] = 1e3 * timed(
                lambda: cg.solve_gnlse_batch_torch(*t, **gn_kw, nl=nl_t), reps=NL_LIB_REPS if nl
                else REPS)
    for rdt in (torch.float64, torch.float32):
        name = f"ssfm_rk45_{suffix(rdt)}"
        rtol, atol = GN_TOL[rdt]
        t, _ = gnlse_lanes(psa, rdt, dev, B=GN_B45)
        kw45 = dict(gn_kw, rtol=rtol, atol=atol)
        r = csa.solve_gnlse_batch_rk45_cuda(*t, **kw45)
        attempts = (r.n_accepted + r.n_rejected).double()
        ms[name] = 1e3 * timed(lambda: csa.solve_gnlse_batch_rk45_cuda(*t, **kw45))
        item = rdt.itemsize
        # this run's attempts; each envelope adds its saves; inputs: A0,
        # gamma, alpha, the phase row, the twiddles; outputs add the counters
        tr, pw = ssfm_attempt_flop(GN_T)
        n_att = float(attempts.sum())
        pw = n_att * pw + GN_B45 * n_saves * 6 * GN_T
        gn_flop[name] = n_att * tr + pw
        gn_bound(name, ops_ms(gn_flop[name], rdt),
                 GN_B45 * (2 * GN_T * item * 2 + 3 * item + 9) + (item + 16) * GN_T)
        steps[name + "_timed"] = (float(attempts.mean()), int(attempts.max()))
        # the same rk45 integration through torch.fft (cuFFT) on the card
        library_ms[name] = 1e3 * timed(lambda: csa.solve_gnlse_batch_rk45_torch(*t, **kw45))
    gn_e2e = {}
    for precision, integ, nl, name, _c, _t in gn_paths:
        B = GN_B45 if integ == "rk45" else GN_B
        A0g, cog, nlg = gnlse_setup(psa, precision, nl, B)
        cfg = gn_cfg(precision, integ)
        gn_e2e[f"{integ} {precision}{' nl' if nl else ''}"] = (B, timed(
            lambda: gn.solve_gnlse_batch(cfg, cog, A0g, nl=nlg, device="cuda")))
    log(f"GNLSE times on {card} (median of {REPS} warm reps, host clock with synchronize; "
        f"bound: the least flop, the Raman pairs as real-input transforms, at FP64 "
        f"{PEAK_FLOPS[torch.float64] / 1e12:g} / FP32 {PEAK_FLOPS[torch.float32] / 1e12:g} "
        f"TFLOP/s; {PEAK_BYTES / 1e12:g} TB/s):")
    for name in ("gnlse_ssfm_f64", "gnlse_ssfm_f32", "gnlse_ssfm_nl_f64", "gnlse_ssfm_nl_f32"):
        nl = "_nl_" in name
        log(f"  {name} {GN_B} envelopes x {GN_STEPS} steps: {ms[name]:.3f} ms = "
            f"{GN_B * GN_STEPS / ms[name] * 1e3:.1f} envelope-steps/s; bound {bound_ms[name]:.3f} "
            f"ms ({bound_by[name]}; {gn_flop[name]:.4g} flop, {bytes_of[name]} bytes; the kernel "
            f"at {100 * bound_ms[name] / ms[name]:.2f}% of it); torch.fft Strang integration "
            f"(cuFFT, the library call{f', median of {NL_LIB_REPS}' if nl else ''}) "
            f"{library_ms[name]:.3f} ms; plain version on the card (one run, phase 15) "
            f"{plain_ms[name]:.1f} ms")
        if not nl:
            rdt = torch.float64 if name.endswith("f64") else torch.float32
            log("    " + strang_layout(_build, "gnlse_ssfm", GN_T, 1, rdt))
    for name in ("ssfm_rk45_f64", "ssfm_rk45_f32"):
        mean, mx = steps[name + "_timed"]
        log(f"  {name} {GN_B45} envelopes: {ms[name]:.3f} ms; bound {bound_ms[name]:.3f} ms "
            f"({bound_by[name]}; {gn_flop[name]:.4g} flop, {bytes_of[name]} bytes; the kernel at "
            f"{100 * bound_ms[name] / ms[name]:.2f}% of it); attempted steps per envelope mean "
            f"{mean:.1f}, max {mx}; torch.fft rk45 integration (cuFFT, the library call) "
            f"{library_ms[name]:.3f} ms; plain version on the card (one run, phase 16) "
            f"{plain_ms[name]:.1f} ms")
    for label, (B, sec) in gn_e2e.items():
        log(f"  solve_gnlse_batch end to end, {label}, {B} envelopes: {sec * 1e3:.3f} ms = "
            f"{B / sec:.1f} envelopes/s")


def lle_setup(psa, precision, B=None):
    """Host ``(psi0 (B, T), coeffs)`` of the bench configuration: the first
    B (default all) of its 4,096 detunings at ``precision``, soliton-ansatz
    seeds."""
    B = LLE_B if B is None else B
    ll = psa.lle
    grid = ll.TimeGrid(n_samples=LLE_T, t_window_s=LLE_WINDOW)
    dets = np.linspace(3.6, 4.4, LLE_B)[:B]
    co = ll.make_lle_coeffs(grid, detuning=dets, pump=LLE_PUMP, d2=LLE_D2, precision=precision)
    return lle_seeds(psa)[:B].copy(), co


@functools.lru_cache(maxsize=1)
def lle_seeds(psa):
    """The bench's 4,096 soliton-ansatz seeds, made once."""
    grid = psa.lle.TimeGrid(n_samples=LLE_T, t_window_s=LLE_WINDOW)
    return np.stack([psa.lle.soliton_ansatz(grid, d, LLE_PUMP, LLE_D2)
                     for d in np.linspace(3.6, 4.4, LLE_B)])


def lle_lanes(psa, rdt, dev, B=None, pump_phase=0.0, bad=False):
    """Kernel inputs ``(psi0, detuning, pump, lin_phase)`` on the card; the
    pump turned by ``pump_phase``; with ``bad``, cavity B//2 starts
    LLE_BAD[rdt] times too strong."""
    B = LLE_B if B is None else B
    psi0, co = lle_setup(psa, "x64", B)
    if bad:
        psi0[B // 2] *= LLE_BAD[rdt]
    det, F, ph = psa.lle.lane_coeffs(co, B, LLE_T, rdt, dev)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return (torch.as_tensor(psi0, device=dev).to(cdt), det,
            (F * complex(np.exp(1j * pump_phase))).contiguous(), ph)


def power_error(A, A_ref):
    """bench_lle.py:277-284: max |P - P_ref| / max P_ref over the subset."""
    P, P_ref = np.abs(A) ** 2, np.abs(A_ref) ** 2
    return float(np.max(np.abs(P - P_ref)) / np.max(P_ref))


def check_lle_kernel(psa, cl, dev, max_err, plain_ms):
    """Phase 19: K7 against its plain version at the bench size with a bad
    cavity; the plain version's 2,000-step fp64 and fp32 runs are its
    times.  fp32 is held against the fp64 plain version of the same case
    (the kernel transforms in double, cuFFT in float32)."""
    B, bad = LLE_B, LLE_B // 2
    kw = dict(dt=LLE_DT, save_every=LLE_SAVE)
    ref64 = {}
    for rdt, n_steps, phase in ((torch.float64, LLE_STEPS, 0.0),
                                (torch.float64, LLE_STEPS + 5, 0.0),
                                (torch.float64, LLE_STEPS, 0.3), (torch.float32, LLE_STEPS, 0.0),
                                (torch.float32, LLE_STEPS, 0.3)):
        t = lle_lanes(psa, rdt, dev, pump_phase=phase, bad=True)
        rk = cl.solve_lle_batch_cuda(*t, n_steps=n_steps, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = cl.solve_lle_batch_torch(*t, n_steps=n_steps, **kw)
        torch.cuda.synchronize()
        key = f"lle_ssfm_{suffix(rdt)}"
        if key not in plain_ms:
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
        label = (f"lle kernel vs plain {str(rdt)[6:]} B={B} n_steps={n_steps}"
                 f"{' complex pump' if phase else ''}")
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{label}: expected exactly cavity {bad} to fail")
        if not (bool(torch.isfinite(rk.A_end).all()) and torch.equal(rk.A_end[bad], t[0][bad])):
            raise AssertionError(f"{label}: the failed cavity is not frozen at its input")
        good = rk.ok
        err_A = normwise(rk.A_end[good], rp.A_end[good])
        err_pk = float(rel_err(rk.peak_max[good], rp.peak_max[good]).max())
        max_err[key] = max(max_err.get(key, 0.0), float((rk.A_end[good] - rp.A_end[good])
                                                        .abs().max()))
        if rdt == torch.float64:
            if n_steps == LLE_STEPS:
                ref64[phase] = rp
            log(f"{label}: A_end max normwise err {err_A:.3e}, peak max rel err {err_pk:.3e} "
                "(bar 1e-11); bad cavity frozen at its input")
            if not (err_A <= 1e-11 and err_pk <= 1e-11):
                raise AssertionError(f"{label}: {err_A:.3e} / {err_pk:.3e} > 1e-11")
            continue
        # fp32: against the fp64 plain version; the bars (PERF.md section 6,
        # PR 5) are a tenth of what a 0.1% error in F reads in A_end and
        # about a seventh of it in the peak
        ref = ref64[phase]
        up = (lambda r: (r.A_end[good].to(torch.complex128), r.peak_max[good].double()))
        (kA, kp), (pA, pp) = up(rk), up(rp)
        ek_A, ek_pk = normwise(kA, ref.A_end[good]), float(rel_err(kp, ref.peak_max[good]).max())
        ep_A, ep_pk = normwise(pA, ref.A_end[good]), float(rel_err(pp, ref.peak_max[good]).max())
        t64 = lle_lanes(psa, torch.float64, dev, pump_phase=phase, bad=True)
        off = cl.solve_lle_batch_torch(t64[0], t64[1], t64[2] * (1 + 1e-3), t64[3],
                                       n_steps=n_steps, **kw)
        log(f"{label}: kernel vs plain fp64 A_end {ek_A:.3e} (bar 3e-4), peak {ek_pk:.3e} "
            f"(bar 1e-4); plain fp32 (cuFFT) vs plain fp64 A_end {ep_A:.3e}, peak {ep_pk:.3e}; "
            f"plain fp64 with F 0.1% off A_end {normwise(off.A_end[good], ref.A_end[good]):.3e}, "
            f"peak {float(rel_err(off.peak_max[good], ref.peak_max[good]).max()):.3e}; "
            f"kernel vs plain fp32 A_end {err_A:.3e}; bad cavity frozen")
        if not (ek_A <= 3e-4 and ek_pk <= 1e-4):
            raise AssertionError(f"{label}: {ek_A:.3e} / {ek_pk:.3e} against fp64 over the bars")


def check_lle_rk45_kernel(psa, csa, dev, max_err, plain_ms, steps):
    """Phase 20: K8's LLE route against its plain version on the rk45
    lane's 512 cavities, one of them overflowing (rejected to dt_min within
    a few dozen attempts); the first run of each dtype is the plain
    version's time.  The trailing span runs in fp32 only: an fp64 plain run
    takes ~75 s (one loop iteration an attempt, ~30,000 attempts)."""
    B, bad = LLE_B45, LLE_B45 // 2
    ref64 = None
    for rdt, n_steps in ((torch.float64, LLE_STEPS), (torch.float32, LLE_STEPS),
                         (torch.float32, LLE_STEPS + 5)):
        rtol, atol = LLE_TOL[rdt]
        t = lle_lanes(psa, rdt, dev, B=B, bad=True)
        kw = dict(dt=LLE_DT, n_steps=n_steps, save_every=LLE_SAVE, rtol=rtol, atol=atol,
                  max_steps=200_000)
        rk = csa.solve_lle_batch_rk45_cuda(*t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = csa.solve_lle_batch_rk45_torch(*t, **kw)
        torch.cuda.synchronize()
        key = f"ssfm_rk45_lle_{suffix(rdt)}"
        label = f"lle rk45 kernel vs plain {str(rdt)[6:]} B={B} n_steps={n_steps}"
        if key not in plain_ms:
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
            attempts = (rk.n_accepted + rk.n_rejected)[rk.ok].double()
            steps[key] = (float(attempts.mean()), int(attempts.max()))
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{label}: expected exactly cavity {bad} to fail")
        if not bool(torch.isfinite(rk.A_end).all()):
            raise AssertionError(f"{label}: non-finite kernel output")
        good = rk.ok
        same = good & (rk.n_accepted == rp.n_accepted) & (rk.n_rejected == rp.n_rejected)
        share = float(same.double().sum() / good.double().sum())
        err_all = normwise(rk.A_end[good], rp.A_end[good])
        err_same = normwise(rk.A_end[same], rp.A_end[same]) if bool(same.any()) else 0.0
        err_pk = float(rel_err(rk.peak_max[good], rp.peak_max[good]).max())
        max_err[key] = max(max_err.get(key, 0.0), float((rk.A_end[good] - rp.A_end[good])
                                                        .abs().max()))
        log(f"{label}: A_end max normwise err {err_all:.3e} (all cavities), {err_same:.3e} "
            f"(equal counters), peak {err_pk:.3e}; counters equal on {share:.4f}; the bad "
            f"cavity rejected {int(rk.n_rejected[bad])} times")
        if rdt == torch.float64:
            for val, bar, where, at_least in ((share, 0.99, "share of equal counters", True),
                                              (err_same, 1e-9, "equal counters", False)):
                if not (val >= bar if at_least else val <= bar):
                    raise AssertionError(f"{label}: {val:.3e} against {bar:g} on {where}")
            continue
        # fp32: against the fp64 plain version at the same tolerance, beside
        # the fp32 plain version's own error and F 0.1% off (PERF.md, PR 5);
        # the trailing span leaves the saved state as it is, so one fp64
        # reference serves both runs
        if ref64 is None:
            t64 = lle_lanes(psa, torch.float64, dev, B=B, bad=True)
            ref64 = csa.solve_lle_batch_rk45_torch(*t64, **kw)
            off = csa.solve_lle_batch_rk45_torch(t64[0], t64[1], t64[2] * (1 + 1e-3), t64[3],
                                                 **kw)
            g2 = good & off.ok
            off_err = normwise(off.A_end[g2], ref64.A_end[g2])
        up = (lambda r: (r.A_end[good].to(torch.complex128), r.peak_max[good].double()))
        (kA, kp), (pA, _pp) = up(rk), up(rp)
        ek_A = normwise(kA, ref64.A_end[good])
        ek_pk = float(rel_err(kp, ref64.peak_max[good]).max())
        log(f"{label}: kernel vs plain fp64 (rtol {rtol:g}) A_end {ek_A:.3e}, peak {ek_pk:.3e} "
            f"(bars 5e-4); plain fp32 (cuFFT) vs plain fp64 A_end "
            f"{normwise(pA, ref64.A_end[good]):.3e}; plain fp64 with F 0.1% off A_end "
            f"{off_err:.3e}")
        if not (ek_A <= 5e-4 and ek_pk <= 5e-4):
            raise AssertionError(f"{label}: {ek_A:.3e} / {ek_pk:.3e} against fp64 over 5e-4")


def lle_phases(psa, _build, cl, csa, dev, card, t_start, rec):
    """Phases 19-22, the LLE path; ``rec`` holds the records the kernels
    line is made of."""
    max_err, plain_ms, steps, launches = (rec[k] for k in ("max_err", "plain_ms", "steps",
                                                           "launches"))
    ms, library_ms = rec["ms"], rec["library_ms"]
    # --- 19. LLE kernel K7 vs plain version ----------------------------------------
    check_lle_kernel(psa, cl, dev, max_err, plain_ms)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 19 done")

    # --- 20. LLE kernel K8 vs plain version ----------------------------------------
    check_lle_rk45_kernel(psa, csa, dev, max_err, plain_ms, steps)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 20 done")

    # --- 21. the LLE main path -----------------------------------------------------
    ll = psa.lle
    lle_paths = (("df32", "rk4", "lle_ssfm_f64", 1e-9), ("x32", "rk4", "lle_ssfm_f32", 1e-4),
                 ("x64", "rk45", "ssfm_rk45_lle_f64", 1e-7),
                 ("x32", "rk45", "ssfm_rk45_lle_f32", 5e-4))

    def lle_cfg(precision, integrator, tol=None, z_max=LLE_STEPS * LLE_DT):
        r, a = tol or LLE_TOL[torch.float32 if precision == "x32" else torch.float64]
        return psa.custom_simulation_config(z_max=z_max, dz=LLE_DT, save_every=LLE_SAVE,
                                            precision=precision, integrator=integrator,
                                            rtol=r, atol=a)

    lle_refs = {}
    for precision, integ, name, bar in lle_paths:
        B = LLE_B45 if integ == "rk45" else LLE_B
        sub = np.linspace(0, B - 1, 8).astype(int)
        psi0, co = lle_setup(psa, precision, B)
        # the first call leaves the device out: the card is the default
        dev_kw = {} if precision == "df32" else {"device": "cuda"}
        t0 = time.perf_counter()
        (pk, A, ok), counts = run_main_path(psa, _build, name, lambda: ll.solve_lle_batch(
            lle_cfg(precision, integ), co, psi0, engine="auto", **dev_kw))
        sec = time.perf_counter() - t0
        if counts != {name: 1}:
            raise AssertionError(f"lle {precision} {integ}: launches {counts}, not one {name}")
        launches[name] = launches.get(name, 0) + counts[name]
        if A.shape != (B, LLE_T) or not ok.all() or not np.isfinite(A).all():
            raise AssertionError(f"lle {precision} {integ}: shape {A.shape}, ok {ok.mean()}")
        if integ not in lle_refs:
            psi_r, co_r = lle_setup(psa, "x64", B)
            co_r = dataclasses.replace(co_r, detuning=co_r.detuning[sub])
            # rk45: the fp64 rk4ip45 at rtol 1e-10 (4th order; a rtol 1e-11
            # rk45 run would take ~320,000 attempts; PERF.md section 6, PR 5)
            ref_cfg = (lle_cfg("x64", "rk4ip45", tol=(1e-10, 1e-13)) if integ == "rk45"
                       else lle_cfg("x64", "rk4"))
            t1 = time.perf_counter()
            lle_refs[integ] = ll.solve_lle_batch(ref_cfg, co_r, psi_r[sub], engine="torch",
                                                 device="cpu")[1]
            log(f"plain fp64 {'rk4ip45 at rtol 1e-10' if integ == 'rk45' else 'Strang'} "
                f"reference on the CPU, 8 cavities: {time.perf_counter() - t1:.1f} s")
        err = power_error(A[sub], lle_refs[integ])
        log(f"main path lle {integ} {precision}: {B} cavities of {LLE_T} samples, launches "
            f"{counts}, ok 1.0, {sec * 1e3:.1f} ms (first call); 8-cavity subset vs plain fp64 "
            f"(CPU): max rel power err {err:.3e} (bar {bar:g})")
        if not err <= bar:
            raise AssertionError(f"lle {precision} {integ} subset error {err:.3e} > {bar:g}")

    scan_kw = dict(detunings=np.linspace(0.5, 4.5, LLE_B), pump=LLE_PUMP, d2=LLE_D2)
    grid = ll.TimeGrid(n_samples=LLE_T, t_window_s=LLE_WINDOW)
    (det, mean_p, pk, psi_last, ok), counts = run_main_path(
        psa, _build, "lle_ssfm_f64", lambda: ll.detuning_scan(lle_cfg("x64", "rk4"), grid,
                                                              device="cuda", **scan_kw))
    launches["lle_ssfm_f64"] += counts["lle_ssfm_f64"]
    lower = np.array([ll.cw_steady_states(d, LLE_PUMP)[0] for d in det])
    # MI rolls and chaos form in about half the band (a 64-point scan on
    # the CPU: 56% of points peak above twice the lower CW branch; the
    # stable CW points read 1.01)
    structured = float(np.mean(pk > 2.0 * lower))
    log(f"detuning_scan x64 over {LLE_B} points of [0.5, 4.5]: launches {counts}, ok "
        f"{ok.mean():.4f}, share of points whose peak is above twice the lower CW branch "
        f"{structured:.3f} (bar 0.25)")
    if counts != {"lle_ssfm_f64": 1} or not (ok.all() and np.isfinite(psi_last).all()
                                             and psi_last.shape == (LLE_B, LLE_T)
                                             and structured >= 0.25):
        raise AssertionError(f"detuning_scan: launches {counts}, ok {ok.mean()}, "
                             f"structured {structured}")

    # the ramp and the single run: plain torch, a soliton held on the card
    psi1, co1 = lle_setup(psa, "x64", 1)
    ramp_kw = dict(detuning_start=3.6, detuning_end=4.4)
    t0 = time.perf_counter()
    tr, dr, Pr = ll.run_lle_ramp(lle_cfg("x64", "rk4"), co1, psi1[0], device="cuda", **ramp_kw)
    sec = time.perf_counter() - t0
    _tc, _dc, Pc = ll.run_lle_ramp(lle_cfg("x64", "rk4"), co1, psi1[0], device="cpu", **ramp_kw)
    err_r = float(np.max(np.abs(Pr - Pc)) / np.max(np.abs(Pc)))
    tz, Az = ll.run_lle_simulation(lle_cfg("x64", "rk4"), co1, psi1[0], device="cuda")
    _tz, Azc = ll.run_lle_simulation(lle_cfg("x64", "rk4"), co1, psi1[0], device="cpu")
    err_s = float(np.max(np.abs(Az - Azc)) / np.max(np.abs(Azc)))
    log(f"run_lle_ramp on the card (2,000 steps, Delta 3.6 -> 4.4, plain torch): {Pr.shape[0]} "
        f"rows in {sec:.1f} s, vs the CPU {err_r:.3e}; run_lle_simulation vs the CPU "
        f"{err_s:.3e} of the largest amplitude (bars 1e-11)")
    if not (Pr.shape == (LLE_STEPS // LLE_SAVE + 1, LLE_T) and err_r <= 1e-11
            and err_s <= 1e-11 and np.isclose(dr[-1], 4.4)):
        raise AssertionError(f"ramp / single run: {err_r:.3e} / {err_s:.3e}")
    psi_ip, co_ip = lle_setup(psa, "x64", 64)
    _build.LAUNCHES.clear()
    _pk, A_ip, ok_ip = ll.solve_lle_batch(lle_cfg("x64", "rk4ip45", z_max=200 * LLE_DT), co_ip,
                                          psi_ip, device="cuda")
    torch.cuda.synchronize()
    log(f"solve_lle_batch rk4ip45 (engine='auto', 64 cavities, 200 steps): launches "
        f"{dict(_build.LAUNCHES)} (plain torch, as the JAX package's 'auto'), ok {ok_ip.mean()}")
    if _build.LAUNCHES or not ok_ip.all():
        raise AssertionError(f"rk4ip45 auto: launches {dict(_build.LAUNCHES)}, ok {ok_ip.mean()}")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 21 done")

    # --- 22. LLE times -------------------------------------------------------------
    bound_ms, bound_by, bytes_of = (rec[k] for k in ("bound_ms", "bound_by", "bytes_of"))
    n_saves = LLE_STEPS // LLE_SAVE
    lle_flop = {}

    def lle_bound(name, rdt, flop, nbytes):
        t_ops, t_bytes = ops_ms(flop, rdt), 1e3 * nbytes / PEAK_BYTES
        lle_flop[name] = flop
        bound_ms[name] = max(t_ops, t_bytes)
        bound_by[name] = "operations" if t_ops >= t_bytes else "bytes"
        bytes_of[name] = nbytes

    pair = fft_flop(LLE_T) + fft_flop(LLE_T, True)
    kw = dict(dt=LLE_DT, n_steps=LLE_STEPS, save_every=LLE_SAVE)
    for rdt in (torch.float64, torch.float32):
        name, item = f"lle_ssfm_{suffix(rdt)}", rdt.itemsize
        t = lle_lanes(psa, rdt, dev)
        ms[name] = 1e3 * timed(lambda: cl.solve_lle_batch_cuda(*t, **kw))
        # a step: a transform pair with the factor product (6 a sample) and
        # the affine write (8), the Kerr rotation (13); a chunk of k steps
        # makes k + 1 linear substeps, each save the finite check and the
        # peak; inputs: psi0, the two factor rows, the (B, 4) affine
        # scalars, the twiddles; outputs: the peak, psi_last, ok
        lle_bound(name, rdt, LLE_B * (LLE_STEPS * (pair + 27 * LLE_T)
                                      + n_saves * (pair + 14 * LLE_T + 12 * LLE_T)),
                  LLE_B * (4 * LLE_T * item + 9 * item + 1) + (4 * item + 16) * LLE_T)
        # the same Strang integration through torch.fft (cuFFT) on the card
        library_ms[name] = 1e3 * timed(lambda: cl.solve_lle_batch_torch(*t, **kw))
    for rdt in (torch.float64, torch.float32):
        name, item = f"ssfm_rk45_lle_{suffix(rdt)}", rdt.itemsize
        rtol, atol = LLE_TOL[rdt]
        t = lle_lanes(psa, rdt, dev, B=LLE_B45)
        kw45 = dict(kw, rtol=rtol, atol=atol, max_steps=200_000)
        r = csa.solve_lle_batch_rk45_cuda(*t, **kw45)
        attempts = (r.n_accepted + r.n_rejected).double()
        ms[name] = 1e3 * timed(lambda: csa.solve_lle_batch_rk45_cuda(*t, **kw45))
        # this run's attempts: K8's attempt and five affine writes (8 a
        # sample); inputs add Delta and F, outputs the counters
        tr, pw = ssfm_attempt_flop(LLE_T)
        n_att = float(attempts.sum())
        lle_bound(name, rdt, n_att * (tr + pw + 40 * LLE_T) + LLE_B45 * n_saves * 6 * LLE_T,
                  LLE_B45 * (4 * LLE_T * item + 4 * item + 9) + (item + 16) * LLE_T)
        steps[name + "_timed"] = (float(attempts.mean()), int(attempts.max()))
        # the library call, the same rk45 integration through torch.fft, is
        # the plain version itself: its phase-20 run (an fp64 run takes
        # ~75 s, so it is not repeated)
        library_ms[name] = plain_ms[name]
    lle_e2e = {}
    for precision, integ, _name, _bar in lle_paths:
        B = LLE_B45 if integ == "rk45" else LLE_B
        psi0, co = lle_setup(psa, precision, B)
        cfg = lle_cfg(precision, integ)
        lle_e2e[f"{integ} {precision}"] = (B, integ, timed(
            lambda: ll.solve_lle_batch(cfg, co, psi0, device="cuda")))
    scan_s = timed(lambda: ll.detuning_scan(lle_cfg("x64", "rk4"), grid, device="cuda",
                                            **scan_kw))
    log(f"LLE times on {card} (median of {REPS} warm reps, host clock with synchronize; bound: "
        f"the least flop at FP64 {PEAK_FLOPS[torch.float64] / 1e12:g} / FP32 "
        f"{PEAK_FLOPS[torch.float32] / 1e12:g} TFLOP/s; {PEAK_BYTES / 1e12:g} TB/s):")
    for name in ("lle_ssfm_f64", "lle_ssfm_f32"):
        log(f"  {name} {LLE_B} cavities x {LLE_STEPS} steps: {ms[name]:.3f} ms = "
            f"{LLE_B * LLE_STEPS / ms[name] * 1e3:.1f} instance-steps/s; bound "
            f"{bound_ms[name]:.3f} ms ({bound_by[name]}; {lle_flop[name]:.4g} flop, "
            f"{bytes_of[name]} bytes; the kernel at {100 * bound_ms[name] / ms[name]:.2f}% of "
            f"it); torch.fft Strang integration (cuFFT, the library call) "
            f"{library_ms[name]:.3f} ms; plain version on the card (one run, phase 19) "
            f"{plain_ms[name]:.1f} ms")
    for name in ("ssfm_rk45_lle_f64", "ssfm_rk45_lle_f32"):
        mean, mx = steps[name + "_timed"]
        log(f"  {name} {LLE_B45} cavities: {ms[name]:.3f} ms = "
            f"{LLE_B45 / ms[name] * 1e3:.1f} cavities/s; bound {bound_ms[name]:.3f} ms "
            f"({bound_by[name]}; {lle_flop[name]:.4g} flop, {bytes_of[name]} bytes; the kernel at "
            f"{100 * bound_ms[name] / ms[name]:.2f}% of it); attempted steps per cavity mean "
            f"{mean:.1f}, max {mx}; plain version on the card, the torch.fft rk45 integration "
            f"and the library call (one run, phase 20) {plain_ms[name]:.1f} ms")
    for label, (B, integ, sec) in lle_e2e.items():
        rate = (f"{B * LLE_STEPS / sec:.1f} instance-steps/s" if integ == "rk4"
                else f"{B / sec:.1f} cavities/s")
        log(f"  solve_lle_batch end to end, {label}, {B} cavities: {sec * 1e3:.3f} ms = {rate}")
    log(f"  detuning_scan end to end, x64, {LLE_B} points (seeds made on the host): "
        f"{scan_s * 1e3:.3f} ms = {LLE_B / scan_s:.1f} points/s")


# The vector configuration of bench_gnlse.py:242-276 (its manakov lanes): the
# GNLSE grid, beta2, gamma, loss, steps and save interval above, over the
# first 1,024 of the 2,048 envelopes (0.5-1.0 x the soliton power), each
# split onto two polarizations at theta = 0.4.  The checks add birefringence
# and the other bodies: cnlse with dbeta0 = 0.3 /m and dbeta1 = 1e-13 s/m,
# isotropic with dbeta0 = 8 /m (the coherent exchange), and Raman with
# self-steepening on the manakov coupling.
VG_B, VG_THETA = 1024, 0.4
VG_CASES = (("manakov", False, {}), ("cnlse", False, dict(dbeta0_1_m=0.3, dbeta1_s_m=1e-13)),
            ("isotropic", False, dict(dbeta0_1_m=8.0)), ("manakov", True, {}))
# the fp32 kernel against the fp64 plain version: bars written before the
# first card run (PERF.md section 6), under the 1.744e-4 that the plain
# version with gamma 0.1% off reads in A_end (ssfm_host_rehearsal.py
# --readings); the peak sits at the input on these pulses, so gamma moves it
# little and its bar is K7's
VG_BAR32 = (1e-4, 1e-4)


def vgnlse_setup(psa, precision, coupling="manakov", nl=False, bire=None, B=None, T=None):
    """Host ``(A0 (B, 2, T), coeffs, nl terms or None)`` of the vector
    configuration at ``precision``."""
    B = VG_B if B is None else B
    T = GN_T if T is None else T
    vg = psa.vgnlse
    grid = vg.TimeGrid.for_pulse(GN_T0, n_samples=T)
    co = vg.make_vgnlse_coeffs(grid, psa.DispersionParams.from_betas(GN_OMEGA0, beta2=GN_BETA2),
                               gamma_W_m=GN_GAMMA, alpha_1_m=GN_ALPHA, coupling=coupling,
                               precision=precision, **(bire or {}))
    terms = (psa.gnlse.make_nl_terms(grid, f_raman=0.18, omega0=GN_OMEGA0, precision=precision)
             if nl else None)
    P0 = psa.gnlse.soliton_peak_power(GN_BETA2, GN_GAMMA, GN_T0)
    A = (np.sqrt(np.linspace(0.5, 1.5, 2 * VG_B)[:B] * P0)[:, None]
         / np.cosh(grid.t()[None, :] / GN_T0))
    A0 = np.stack([np.cos(VG_THETA) * A, np.sin(VG_THETA) * A], axis=1)
    return A0.astype(np.complex128), co, terms


def vgnlse_lanes(psa, rdt, dev, coupling="manakov", nl=False, bire=None, B=None, T=None,
                 bad_alpha=None):
    """Kernel inputs ``(A0, gamma, alpha, b_xpm, lin_phase)``, ``coherent``
    and nl terms on the card; instance B//2 has the loss ``bad_alpha`` (a
    gain that overflows within the first chunk)."""
    B = VG_B if B is None else B
    T = GN_T if T is None else T
    A0, co, terms = vgnlse_setup(psa, "x64", coupling, nl, bire, B, T)
    g, a, b, ph = psa.vgnlse.lane_coeffs(co, B, T, rdt, dev)
    if bad_alpha is not None:
        a = a.clone()
        a[B // 2] = bad_alpha
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return ((torch.as_tensor(A0, device=dev).to(cdt), g, a, b, ph), co.coherent,
            psa.gnlse._cast_nl(terms, rdt, dev))


def vnormwise(k, p):
    """Worst over instances of max |k - p| / max |p| over both
    polarizations."""
    return normwise(k.flatten(1), p.flatten(1))


def vgnlse_step_flop(n, body):
    """The least work of one K9 step on both polarizations, as ``(transform
    flop, pointwise flop)``: a linear substep a polarization (a transform
    pair and a 6-flop factor product a sample) and the nonlinear one: the
    joint rotation (15 a sample a polarization: both powers, the angle,
    sin, cos and the product), the coherent RK4 (four evaluations of the
    coupling and i gamma, 30 flop a sample a polarization, 24 for the stage
    sums), or the nl RK4: per evaluation one Raman pair on the total power
    (real-input transforms, half a complex pair) and one shock pair a
    polarization, 30 + 8 flop a sample a polarization."""
    pair = fft_flop(n) + fft_flop(n, True)
    if body == "rotation":
        return 2 * pair, 2 * n * (6 + 15)
    if body == "coherent":
        return 2 * pair, 2 * n * (6 + 4 * 30 + 24)
    return 2 * pair + 4 * (0.5 * pair + 2 * pair), 2 * n * (6 + 4 * 38 + 24)


def check_vgnlse_kernel(psa, cv, dev, max_err, plain_ms):
    """Phase 23: vgnlse_ssfm.cu against its plain version at the vector
    configuration with a blown-up instance, each body; a trailing partial
    chunk (1,005 steps) on the manakov case; the nl body also at T = 2,048
    (the widest it takes; 256 instances).  fp64 within 1e-11 of each
    instance's largest amplitude; fp32 against the fp64 plain version of
    the same case.  The plain version's 1,000-step run of each body at
    T = 1,024 is its time."""
    runs = [(torch.float64, c, GN_STEPS, GN_T, VG_B) for c in VG_CASES]
    runs += [(torch.float64, VG_CASES[0], GN_STEPS + 5, GN_T, VG_B)]
    runs += [(torch.float32, c, GN_STEPS, GN_T, VG_B) for c in VG_CASES]
    runs += [(torch.float64, VG_CASES[3], GN_STEPS, 2 * GN_T, VG_B // 4),
             (torch.float32, VG_CASES[3], GN_STEPS, 2 * GN_T, VG_B // 4)]
    ref64 = {}
    for rdt, (coupling, nl, bire), n_steps, T, B in runs:
        t, coh, nl_t = vgnlse_lanes(psa, rdt, dev, coupling, nl, bire, B, T, bad_alpha=-4e6)
        kw = dict(dz_m=GN_Z / GN_STEPS, n_steps=n_steps, save_every=GN_SAVE, nl=nl_t)
        label = (f"vgnlse kernel vs plain {str(rdt)[6:]} {coupling}{' nl' if nl else ''} B={B} "
                 f"T={T} n_steps={n_steps}")
        body = cv.body_of(coh, nl_t)
        key = f"vgnlse_ssfm{'' if body == 'rotation' else '_' + body}_{suffix(rdt)}"
        why = cv.width_problem(T, rdt, dev, body)
        if why is not None:
            raise AssertionError(f"{label}: the kernel refuses it ({why})")
        rk = cv.solve_vgnlse_batch_cuda(*t, coh, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp = cv.solve_vgnlse_batch_torch(*t, coh, **kw)
        torch.cuda.synchronize()
        if n_steps == GN_STEPS and T == GN_T and coupling != "cnlse":
            plain_ms[key] = 1e3 * (time.perf_counter() - t0)
        if rdt == torch.float64 and n_steps == GN_STEPS:
            ref64[(coupling, nl, T)] = rp
        bad = B // 2
        if not torch.equal(rk.ok, rp.ok):
            raise AssertionError(f"{label}: ok flags differ")
        if bool(rk.ok[bad]) or int(rk.ok.sum()) != B - 1:
            raise AssertionError(f"{label}: expected exactly instance {bad} to fail")
        if not (bool(torch.isfinite(rk.A_end).all()) and torch.equal(rk.A_end[bad], t[0][bad])):
            raise AssertionError(f"{label}: the failed instance is not frozen at its input")
        good = rk.ok
        err_A = vnormwise(rk.A_end[good], rp.A_end[good])
        err_pk = float(rel_err(rk.peak_max[good], rp.peak_max[good]).max())
        max_err[key] = max(max_err.get(key, 0.0), float((rk.A_end[good] - rp.A_end[good])
                                                        .abs().max()))
        if rdt == torch.float64:
            log(f"{label}: A_end max normwise err {err_A:.3e}, peak max rel err {err_pk:.3e} "
                "(bar 1e-11); bad instance frozen at its input")
            if not (err_A <= 1e-11 and err_pk <= 1e-11):
                raise AssertionError(f"{label}: {err_A:.3e} / {err_pk:.3e} > 1e-11")
            continue
        ref = ref64[(coupling, nl, T)]
        ek_A = vnormwise(rk.A_end[good].to(torch.complex128), ref.A_end[good])
        ek_pk = float(rel_err(rk.peak_max[good].double(), ref.peak_max[good]).max())
        ep_A = vnormwise(rp.A_end[good].to(torch.complex128), ref.A_end[good])
        ep_pk = float(rel_err(rp.peak_max[good].double(), ref.peak_max[good]).max())
        log(f"{label}: kernel vs plain fp64 A_end {ek_A:.3e} (bar {VG_BAR32[0]:g}), peak "
            f"{ek_pk:.3e} (bar {VG_BAR32[1]:g}); plain fp32 (cuFFT) vs plain fp64 A_end "
            f"{ep_A:.3e}, peak {ep_pk:.3e}; kernel vs plain fp32 A_end {err_A:.3e}, peak "
            f"{err_pk:.3e}; bad instance frozen")
        if coupling == "manakov" and not nl:
            # what a wrong kernel would read: the plain fp64 version with
            # every gamma 0.1% off
            t64, _, _ = vgnlse_lanes(psa, torch.float64, dev, coupling, nl, bire, B, T,
                                     bad_alpha=-4e6)
            off = cv.solve_vgnlse_batch_torch(t64[0], t64[1] * (1 + 1e-3), *t64[2:], coh,
                                              **dict(kw, nl=None))
            log(f"{label}: the plain fp64 version with gamma 0.1% off reads A_end "
                f"{vnormwise(off.A_end[good], ref.A_end[good]):.3e}, peak "
                f"{float(rel_err(off.peak_max[good], ref.peak_max[good]).max()):.3e}")
        if not (ek_A <= VG_BAR32[0] and ek_pk <= VG_BAR32[1]):
            raise AssertionError(f"{label}: {ek_A:.3e} / {ek_pk:.3e} against fp64 over the bars")


def vgnlse_phases(psa, _build, cv, cg, dev, card, t_start, rec):
    """Phases 23-26, the vector GNLSE path; ``rec`` holds the records the
    kernels line is made of."""
    max_err, plain_ms, launches = rec["max_err"], rec["plain_ms"], rec["launches"]
    ms, bound_ms, bound_by, bytes_of = (rec[k] for k in ("ms", "bound_ms", "bound_by",
                                                         "bytes_of"))
    library_ms = rec["library_ms"]
    # --- 23. vector kernel K9 vs plain version -------------------------------------
    check_vgnlse_kernel(psa, cv, dev, max_err, plain_ms)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 23 done")

    # --- 24. one empty polarization: K9 is K6 ---------------------------------------
    # the rotation against Kerr shares the slotted Strang body (each
    # polarization with the operations of K6's one) and the angle: bit for
    # bit; the nl
    # bodies share wide_fft, but K9 forms W_p = (1 - f_R) K_p + f_R R A_p
    # where K6 forms A ((1 - f_R) P + f_R R): equal to rounding
    for nl in (False, True):
        for rdt in (torch.float64, torch.float32):
            t, coh, nl_t = vgnlse_lanes(psa, rdt, dev, "cnlse", nl)
            A0 = t[0].clone()
            A0[:, 1] = 0
            kw = dict(dz_m=GN_Z / GN_STEPS, n_steps=GN_STEPS, save_every=GN_SAVE, nl=nl_t)
            rv = cv.solve_vgnlse_batch_cuda(A0, *t[1:], coh, **kw)
            rs = cg.solve_gnlse_batch_cuda(A0[:, 0].contiguous(), t[1], t[2],
                                           t[4][0].contiguous(), **kw)
            torch.cuda.synchronize()
            err = normwise(rv.A_end[:, 0], rs.A_end)
            bit = torch.equal(rv.A_end[:, 0], rs.A_end) and torch.equal(rv.peak_max[:, 0],
                                                                        rs.peak_max)
            if nl:
                bar = 1e-11 if rdt == torch.float64 else 1e-4
            else:
                bar = 1e-11 if rdt == torch.float64 else 1e-5
            label = (f"empty polarization {str(rdt)[6:]}{' nl' if nl else ''}: K9 (cnlse, "
                     f"A_y = 0) vs K6 on A_x at the same gamma"
                     f"{', f_R and 1/omega_0' if nl else ''}")
            log(f"{label}, {VG_B} instances: A_end {err:.3e} (bar {bar:g}), bit for bit {bit}; "
                f"A_y stays 0: {not bool(rv.A_end[:, 1].abs().any())}")
            if not (err <= bar and bool(rv.ok.all()) and not bool(rv.A_end[:, 1].abs().any())):
                raise AssertionError(f"{label}: {err:.3e}")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 24 done")

    # --- 25. the vector main path -----------------------------------------------------
    vg = psa.vgnlse
    sub = np.linspace(0, VG_B - 1, 8).astype(int)
    vg_paths = (("df32", VG_CASES[0], "vgnlse_ssfm_f64", 1e-9, 1e-9),
                ("x32", VG_CASES[0], "vgnlse_ssfm_f32", 4.5e-3, 2.6e-2),
                ("df32", VG_CASES[2], "vgnlse_ssfm_coherent_f64", 1e-9, 1e-9),
                ("x32", VG_CASES[2], "vgnlse_ssfm_coherent_f32", 4.5e-3, 2.6e-2),
                ("df32", VG_CASES[3], "vgnlse_ssfm_nl_f64", 1e-9, 1e-9),
                ("x32", VG_CASES[3], "vgnlse_ssfm_nl_f32", 4.5e-3, 2.6e-2))

    def vg_cfg(precision, integrator="rk4", **kw):
        return psa.custom_simulation_config(z_max=GN_Z, dz=GN_Z / GN_STEPS, save_every=GN_SAVE,
                                            precision=precision, integrator=integrator, **kw)

    vg_refs = {}
    for precision, (coupling, nl, bire), name, core_bar, tail_bar in vg_paths:
        A0v, cov, nlv = vgnlse_setup(psa, precision, coupling, nl, bire)
        # the first call leaves the device out: the card is the default
        dev_kw = {} if precision == "df32" and coupling == "manakov" else {"device": "cuda"}
        t0 = time.perf_counter()
        (pk, A, ok), counts = run_main_path(psa, _build, name, lambda: vg.solve_vgnlse_batch(
            vg_cfg(precision), cov, A0v, nl=nlv, engine="auto", **dev_kw))
        sec = time.perf_counter() - t0
        label = f"vgnlse {precision} {coupling}{' nl' if nl else ''}"
        if counts != {name: 1}:
            raise AssertionError(f"{label}: launches {counts}, not one {name}")
        launches[name] = launches.get(name, 0) + counts[name]
        if (A.shape != (VG_B, 2, GN_T) or pk.shape != (VG_B, 2) or not ok.all()
                or not np.isfinite(A).all()):
            raise AssertionError(f"{label}: shape {A.shape}, ok {ok.mean()}")
        key = (coupling, nl)
        if key not in vg_refs:
            A0r, cor, nlr = vgnlse_setup(psa, "x64", coupling, nl, bire)
            t1 = time.perf_counter()
            vg_refs[key] = vg.solve_vgnlse_batch(vg_cfg("x64"), cor, A0r[sub], nl=nlr,
                                                 engine="torch", device="cpu")[1]
            log(f"plain fp64 {coupling}{' nl' if nl else ''} reference on the CPU, 8 instances: "
                f"{time.perf_counter() - t1:.1f} s")
        core, tails = power_errors(A[sub], vg_refs[key])
        log(f"main path {label}: {VG_B} instances of 2 x {GN_T} samples, launches {counts}, "
            f"ok 1.0, {sec * 1e3:.1f} ms (first call); 8-instance subset vs plain fp64 (CPU): "
            f"max rel power err {core:.3e} on the core (bar {core_bar:g}), {tails:.3e} on the "
            f"tails (bar {tail_bar:g})")
        if not (core <= core_bar and tails <= tail_bar):
            raise AssertionError(f"{label} subset error {core:.3e} / {tails:.3e}")

    A0s, cos_, _ = vgnlse_setup(psa, "x64", "cnlse", bire=VG_CASES[1][2], B=16)
    t0 = time.perf_counter()
    z, A = vg.run_vgnlse_simulation(vg_cfg("x64"), cos_, A0s[0], device="cuda")
    sec = time.perf_counter() - t0
    z_c, A_c = vg.run_vgnlse_simulation(vg_cfg("x64"), cos_, A0s[0], device="cpu")
    err = float(np.max(np.abs(A - A_c)) / np.max(np.abs(A_c)))
    log(f"run_vgnlse_simulation on the card (cnlse with birefringence, 1,000 Strang steps, plain "
        f"torch): {A.shape[0]} rows in {sec:.1f} s; vs the CPU {err:.3e} of the largest "
        "amplitude (bar 1e-11)")
    if not (A.shape == (GN_STEPS // GN_SAVE + 1, 2, GN_T) and np.array_equal(z, z_c)
            and err <= 1e-11):
        raise AssertionError(f"run_vgnlse_simulation: shape {A.shape}, error {err:.3e}")
    zt, At, okt = vg.solve_vgnlse_batch_trajectories(vg_cfg("x64"), cos_, A0s, device="cuda")
    zc, Ac, okc = vg.solve_vgnlse_batch_trajectories(vg_cfg("x64"), cos_, A0s, device="cpu")
    err = float(np.max(np.abs(At - Ac)) / np.max(np.abs(Ac)))
    log(f"solve_vgnlse_batch_trajectories on the card (16 instances, plain torch): vs the CPU "
        f"{err:.3e} of the largest amplitude (bar 1e-11)")
    if not (At.shape == (16, GN_STEPS // GN_SAVE + 1, 2, GN_T) and okt.all() and okc.all()
            and err <= 1e-11):
        raise AssertionError(f"solve_vgnlse_batch_trajectories: error {err:.3e}")
    cfg45 = vg_cfg("x64", "rk45", rtol=1e-9, atol=1e-12)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    _pk, A45, ok45 = vg.solve_vgnlse_batch(cfg45, cos_, A0s, device="cuda")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    _pk, A45c, _ok = vg.solve_vgnlse_batch(cfg45, cos_, A0s, device="cpu")
    core, _tails = power_errors(A45, A45c)
    log(f"solve_vgnlse_batch rk45 x64 (engine='auto', 16 instances): launches {counts} (the "
        f"plain torch controller: neither package has a kernel), ok {ok45.mean()}, {sec:.1f} s; "
        f"vs the CPU max rel power err {core:.3e} on the core (bar 1e-7)")
    if counts or not ok45.all() or not core <= 1e-7:
        raise AssertionError(f"rk45 auto: launches {counts}, ok {ok45.mean()}, {core:.3e}")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 25 done")

    # --- 26. vector times -------------------------------------------------------------
    kw = dict(dz_m=GN_Z / GN_STEPS, n_steps=GN_STEPS, save_every=GN_SAVE)
    n_saves = GN_STEPS // GN_SAVE
    vg_flop = {}
    for rdt in (torch.float64, torch.float32):
        item = rdt.itemsize
        # inputs: A0, the two shared factor planes, gamma, the float64
        # twiddles (nl: conj(H_R), omega); outputs: the two peaks, A_end, ok
        nbytes = VG_B * (2 * 2 * GN_T * item * 2 + 3 * item + 1) + (2 * 2 * 2 * item + 16) * GN_T
        for coupling, nl, bire in VG_CASES[:1] + VG_CASES[2:]:
            t, coh, nl_t = vgnlse_lanes(psa, rdt, dev, coupling, nl, bire)
            body = cv.body_of(coh, nl_t)
            name = f"vgnlse_ssfm{'' if body == 'rotation' else '_' + body}_{suffix(rdt)}"
            ms[name] = 1e3 * timed(lambda: cv.solve_vgnlse_batch_cuda(*t, coh, nl=nl_t, **kw))
            # a chunk of k steps makes k + 1 linear substeps; each save adds
            # the finite check and the two peaks
            tr, pw = vgnlse_step_flop(GN_T, body)
            pair2 = 2 * (fft_flop(GN_T) + fft_flop(GN_T, True))
            flop = VG_B * (GN_STEPS * (tr + pw) + n_saves * (pair2 + 2 * 12 * GN_T))
            nb = nbytes + (3 * GN_T * item if nl else 0)
            vg_flop[name] = flop
            bound_ms[name] = max(ops_ms(flop, rdt), 1e3 * nb / PEAK_BYTES)
            bound_by[name] = "operations" if ops_ms(flop, rdt) >= 1e3 * nb / PEAK_BYTES else "bytes"
            bytes_of[name] = nb
            # the same Strang integration through torch.fft (cuFFT) on the card;
            # the coherent and nl ones with fewer reps
            library_ms[name] = 1e3 * timed(
                lambda: cv.solve_vgnlse_batch_torch(*t, coh, nl=nl_t, **kw),
                reps=REPS if body == "rotation" else NL_LIB_REPS)
    vg_e2e = {}
    for precision, (coupling, nl, bire), _name, _c, _t in vg_paths:
        A0v, cov, nlv = vgnlse_setup(psa, precision, coupling, nl, bire)
        cfg = vg_cfg(precision)
        vg_e2e[f"{precision} {coupling}{' nl' if nl else ''}"] = timed(
            lambda: vg.solve_vgnlse_batch(cfg, cov, A0v, nl=nlv, device="cuda"))
    log(f"vector GNLSE times on {card} (median of {REPS} warm reps, host clock with "
        f"synchronize; bound: the least flop, two transform pairs a step, the Raman pair as "
        f"real-input transforms, at FP64 {PEAK_FLOPS[torch.float64] / 1e12:g} / FP32 "
        f"{PEAK_FLOPS[torch.float32] / 1e12:g} TFLOP/s; {PEAK_BYTES / 1e12:g} TB/s):")
    for rdt in (torch.float64, torch.float32):
        for body in ("rotation", "coherent", "nl"):
            name = f"vgnlse_ssfm{'' if body == 'rotation' else '_' + body}_{suffix(rdt)}"
            k6 = f"gnlse_ssfm{'_nl' if body == 'nl' else ''}_{suffix(rdt)}"
            log(f"  {name} {VG_B} instances x 2 x {GN_T} samples x {GN_STEPS} steps: "
                f"{ms[name]:.3f} ms = {VG_B * GN_STEPS / ms[name] * 1e3:.1f} instance-steps/s; "
                f"bound {bound_ms[name]:.3f} ms ({bound_by[name]}; {vg_flop[name]:.4g} flop, "
                f"{bytes_of[name]} bytes; the kernel at {100 * bound_ms[name] / ms[name]:.2f}% "
                f"of it); torch.fft Strang integration (cuFFT, the library call"
                f"{'' if body == 'rotation' else f', median of {NL_LIB_REPS}'}) "
                f"{library_ms[name]:.3f} ms; plain version on the card (one run, phase 23) "
                f"{plain_ms[name]:.1f} ms"
                + ("" if body == "coherent" else
                   f"; K6 {'nl' if body == 'nl' else 'kerr'} on the same samples (2,048 "
                   f"envelopes, phase 18) {ms[k6]:.3f} ms"))
            if body != "nl":
                log("    " + strang_layout(_build, "vgnlse_ssfm", GN_T, 2, rdt,
                                           "Rotation" if body == "rotation" else "Coherent"))
    for label, sec in vg_e2e.items():
        log(f"  solve_vgnlse_batch end to end, {label}, {VG_B} instances: {sec * 1e3:.3f} ms = "
            f"{VG_B * GN_STEPS / sec:.1f} instance-steps/s")


def main():
    # --- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False -- this check needs "
                 "a CUDA card and never runs on the CPU")
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

    t_start = time.perf_counter()
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
    libs = _build.build()
    for name in libs:
        _build.load_library(name)
    log(f"build: {', '.join(p.name for p in libs.values())} ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.find_nvcc()})")
    log("  nvcc seconds a source, all started together: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in sorted(_build.build_seconds().items(),
                                                   key=lambda kv: -kv[1])))
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    common = bench_common(psa)
    max_err, plain_ms, steps, launches = {}, {}, {}, {}

    # --- 3. fixed-step kernel vs plain version ---------------------------------
    check_fixed_kernel(psa, cs, common, dev, max_err, plain_ms)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3 done")

    # --- 4. rk45 kernel vs plain version -----------------------------------------
    check_rk45_kernel(psa, ca, common, dev, max_err, plain_ms, steps)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 4 done")

    # --- 5. the rk4 main path at full size ----------------------------------------
    lam3 = np.linspace(1540e-9, 1650e-9, N_POINTS)
    for precision, rdt in (("df32", torch.float64), ("x32", torch.float32)):
        name = f"fwm4_rk_{suffix(rdt)}"
        res, counts = run_main_path(psa, _build, name, lambda: psa.gain_spectrum(
            cfg=cfg_for(psa, precision), lambda_signal_m=lam3, device="cuda", engine="auto",
            **common))
        launches[name] = counts[name]
        ok_frac = check_spectrum(res, precision)
        log(f"main path rk4 {precision}: {N_POINTS} points, launches {counts}, "
            f"ok {ok_frac:.4f}, peak gain {np.nanmax(res.gain):.4f} dB, "
            f"{res.points_per_s:.1f} pts/s (first call)")

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
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 5 done")

    # --- 6. the rk45 main path at full size ---------------------------------------
    for precision, rdt in (("df32", torch.float64), ("x32", torch.float32)):
        name = f"fwm4_rk45_{suffix(rdt)}"
        res, counts = run_main_path(psa, _build, name, lambda: psa.gain_spectrum(
            cfg=cfg45_for(psa, precision), lambda_signal_m=lam3, device="cuda", engine="auto",
            **common))
        launches[name] = counts[name]
        ok_frac = check_spectrum(res, precision)
        log(f"main path rk45 {precision}: {N_POINTS} points, launches {counts}, "
            f"ok {ok_frac:.4f}, peak gain {np.nanmax(res.gain):.4f} dB, "
            f"{res.points_per_s:.1f} pts/s (first call)")
    t0 = time.perf_counter()
    ref45 = psa.gain_spectrum(cfg=cfg45_for(psa, "x64", rtol=1e-11, atol=1e-14),
                              lambda_signal_m=sub, device="cpu", engine="torch", **common)
    log(f"plain fp64 rk45 reference on the CPU, 32 points at rtol 1e-11: "
        f"{time.perf_counter() - t0:.1f} s")
    for precision, bar in (("df32", 1e-7), ("x32", 5e-4)):
        fast = psa.gain_spectrum(cfg=cfg45_for(psa, precision), lambda_signal_m=sub,
                                 device="cuda", **common)
        err = float(np.nanmax(np.abs(lin(fast.gain) / lin(ref45.gain) - 1.0)))
        log(f"32-point subset rk45 {precision} (card, kernel) vs plain fp64 rk45 (CPU, "
            f"rtol 1e-11): max rel err {err:.3e} in linear gain (bar {bar:g})")
        if not (err <= bar and fast.ok.all()):
            raise AssertionError(f"rk45 {precision} subset error {err:.3e} > {bar:g}")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 6 done")

    # --- 7. the other sweeps ---------------------------------------------------------
    gm_kw = dict(cfg=cfg_for(psa, "df32"), lambda_signal_m=np.linspace(1540e-9, 1650e-9, 640),
                 pump_powers_W=np.linspace(0.1, 0.8, 16), p_seed=(1e-7, 1e-7),
                 **{k: common[k] for k in ("lambda_p1_m", "lambda_p2_m", "gamma", "alpha",
                                           "dispersion", "phase_matching_cfg", "length_unit",
                                           "frame")})
    gm, counts = run_main_path(psa, _build, "fwm4_rk_f64", lambda: psa.gain_map_power_wavelength(
        **gm_kw, device="cuda"))
    gm_plain = psa.gain_map_power_wavelength(**gm_kw, device="cuda", engine="torch")
    gm_err = max_rel(lin(gm.gain)[gm.ok], lin(gm_plain.gain)[gm.ok])
    log(f"gain_map_power_wavelength df32, {gm.gain.shape[0]} x {gm.gain.shape[1]} = "
        f"{gm.gain.size} cells: launches {counts}, "
        f"ok {gm.ok.mean():.4f}; kernel vs plain on the card {gm_err:.3e} (bar 1e-11)")
    if not (gm_err <= 1e-11 and np.array_equal(gm.ok, gm_plain.ok) and gm.ok.mean() >= 0.99):
        raise AssertionError(f"gain map: error {gm_err:.3e}, ok {gm.ok.mean()}")

    ms_kw = dict(cfg=psa.custom_simulation_config(z_max=0.5, dz=1e-3, save_every=10,
                                                  precision="x32", integrator="rk45",
                                                  rtol=1e-6, atol=1e-10),
                 gamma=10.0, alpha=0.0, p_in=[0.5, 0.5, 1e-4, 0.0],
                 delta_beta_values=np.linspace(-30.0, 10.0, 256), gain_mode="end",
                 gain_unit="linear", length_unit="km")
    (sig, idl), counts = run_main_path(psa, _build, "fwm4_rk45_f32", lambda: psa.mismatch_scan(
        **ms_kw, device="cuda"))
    sig_p, idl_p = psa.mismatch_scan(**ms_kw, device="cuda", engine="torch")
    ms_err = max(max_rel(sig.gain, sig_p.gain), max_rel(idl.gain, idl_p.gain))
    log(f"mismatch_scan rk45 x32, 256 points: launches {counts}, ok {sig.ok.mean():.4f}; "
        f"kernel vs plain on the card {ms_err:.3e} (bar 1e-4)")
    if not (ms_err <= 1e-4 and sig.ok.all()):
        raise AssertionError(f"mismatch_scan: error {ms_err:.3e}")

    ps_kw = dict(cfg=ms_kw["cfg"], gamma=10.0, alpha=0.0, p_in=[0.3, 0.3, 1e-3, 1e-3],
                 signal_phases=np.linspace(0.0, 2 * np.pi, 256), delta_beta=0.0,
                 gain_unit="linear", length_unit="km")
    ps, counts = run_main_path(psa, _build, "fwm4_rk45_f32", lambda: psa.psa_phase_sweep(
        **ps_kw, device="cuda"))
    ps_p = psa.psa_phase_sweep(**ps_kw, device="cuda", engine="torch")
    ps_err = max_rel(ps.gain, ps_p.gain)
    log(f"psa_phase_sweep rk45 x32, 256 phases: launches {counts}, gain max/min "
        f"{ps.gain.max() / ps.gain.min():.3f}; kernel vs plain on the card {ps_err:.3e} "
        "(bar 1e-4)")
    if not (ps_err <= 1e-4 and ps.ok.all() and ps.gain.max() / ps.gain.min() > 1.5):
        raise AssertionError(f"psa_phase_sweep: error {ps_err:.3e}")

    B_t = 8
    tr_co = psa.RHSCoeffs(np.full(B_t, 0.0115), np.full(B_t, 1.15e-4), np.linspace(-0.5, 0.5, B_t))
    tr_A0 = np.broadcast_to(np.sqrt(common["p_in"]).astype(np.complex128), (B_t, 4))
    for integ, bar in (("rk4", 1e-11), ("rk45", 1e-8)):
        tr_cfg = psa.custom_simulation_config(z_max=50.0, dz=0.2, save_every=25, integrator=integ,
                                              rtol=1e-10, atol=1e-13)
        z, A, ok = psa.solve_batch_trajectories(tr_cfg, tr_co, tr_A0, device="cuda")
        z_c, A_c, ok_c = psa.solve_batch_trajectories(tr_cfg, tr_co, tr_A0, device="cpu")
        tr_err = max_rel(A, A_c)
        log(f"solve_batch_trajectories {integ}, B={B_t}, {A.shape[1]} rows: card vs CPU "
            f"{tr_err:.3e} (bar {bar:g}; plain torch on both)")
        if not (tr_err <= bar and ok.all() and np.array_equal(z, z_c)):
            raise AssertionError(f"trajectories {integ}: error {tr_err:.3e}")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 7 done")

    # --- 8. the default device -----------------------------------------------------
    res, counts = run_main_path(psa, _build, "fwm4_rk_f64", lambda: psa.gain_spectrum(
        cfg=cfg_for(psa, "df32"), lambda_signal_m=lam3, **common))
    log(f"gain_spectrum with device left out: launches {counts}, ok {res.ok.mean():.4f}")
    check_spectrum(res, "df32 (default device)")

    # --- 9. times ----------------------------------------------------------------
    kw = dict(dz_m=0.2, n_steps=2500, save_every=10, integrator="rk4")
    ms, bound_ms, bound_by, bytes_of, layout = {}, {}, {}, {}, {}

    def bound(name, rdt, flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS[rdt], nbytes / PEAK_BYTES
        bound_ms[name] = 1e3 * max(t_ops, t_bytes)
        bound_by[name] = "operations" if t_ops >= t_bytes else "bytes"
        bytes_of[name] = nbytes

    for rdt in (torch.float64, torch.float32):
        name = f"fwm4_rk_{suffix(rdt)}"
        t = lanes(psa, common, N_POINTS, rdt, dev)
        ms[name] = 1e3 * timed(lambda: cs.solve_batch_cuda(*t, **kw))
        layout[name] = fwm4_layout(_build, "fwm4_rk", N_POINTS, rdt)
        # inputs: A0 (8 reals), gamma, alpha, dbeta; outputs: P_max (4),
        # A_end (8), ok (1 byte)
        bound(name, rdt, N_POINTS * (2500 * RK4_STEP_FLOP[rdt] + 250 * SAVE_FLOP),
              N_POINTS * ((3 + 8 + 4 + 8) * rdt.itemsize + 1))
    t = lanes(psa, common, N_STEADY, torch.float64, dev)
    ms_steady = 1e3 * timed(lambda: cs.solve_batch_cuda(*t, **kw))
    for rdt in (torch.float64, torch.float32):
        name = f"fwm4_rk45_{suffix(rdt)}"
        rtol, atol = RK45_TOL[rdt]
        t = lanes(psa, common, N_POINTS, rdt, dev)
        kw45 = dict(dz_m=0.2, n_steps=2500, save_every=10, rtol=rtol, atol=atol)
        r = ca.solve_batch_rk45_cuda(*t, **kw45)
        attempts = (r.n_accepted + r.n_rejected).double()
        ms[name] = 1e3 * timed(lambda: ca.solve_batch_rk45_cuda(*t, **kw45))
        # this run's attempted steps; outputs add the two int32 counters
        bound(name, rdt, float(attempts.sum()) * DP45_ATTEMPT_FLOP
              + N_POINTS * (RHS_FLOP + 250 * SAVE_FLOP),
              N_POINTS * ((3 + 8 + 4 + 8) * rdt.itemsize + 1 + 8))
        steps[name + "_timed"] = (float(attempts.mean()), int(attempts.max()))
        layout[name] = fwm4_layout(_build, "fwm4_rk45", N_POINTS, rdt)
    e2e = {}
    for label, cfg in (("rk4 df32", cfg_for(psa, "df32")), ("rk4 x32", cfg_for(psa, "x32")),
                       ("rk45 df32", cfg45_for(psa, "df32")), ("rk45 x32", cfg45_for(psa, "x32"))):
        e2e[label] = timed(lambda: psa.gain_spectrum(
            cfg=cfg, lambda_signal_m=lam3, device="cuda", **common))
    log(f"times on {card} (median of {REPS} warm reps, host clock with synchronize):")
    for name in ms:
        extra = f"; plain version on the card (one run, phase 3) {plain_ms[name]:.1f} ms"
        if name.startswith("fwm4_rk45"):
            mean, mx = steps[name + "_timed"]
            extra = (f"; attempted steps per lane mean {mean:.1f}, max {mx}, max / mean "
                     f"{mx / mean:.3f}; the tail lane's time an attempt (kernel time / max "
                     f"attempts) {1e3 * ms[name] / mx:.4f} us; plain version on the card over "
                     f"100 m (one run, phase 4) {plain_ms[name]:.1f} ms")
        log(f"  {name} {N_POINTS} points: {ms[name]:.3f} ms = {N_POINTS / ms[name] * 1e3:.1f} "
            f"pts/s; bound {bound_ms[name]:.3f} ms ({bound_by[name]}; {bytes_of[name]} bytes)"
            f"{extra}")
        log(f"    launch: {layout[name]}")
    log(f"  fwm4_rk_f64 {N_STEADY} points: {ms_steady:.3f} ms = "
        f"{N_STEADY / ms_steady * 1e3:.1f} pts/s")
    log(f"    launch: {fwm4_layout(_build, 'fwm4_rk', N_STEADY, torch.float64)}")
    for label, sec in e2e.items():
        log(f"  gain_spectrum end to end, {label}, {N_POINTS} points: {sec * 1e3:.3f} ms = "
            f"{N_POINTS / sec:.1f} pts/s")

    # --- 10. single run on the card ------------------------------------------------
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
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 10 done")

    # --- 11. comb kernel K4 vs plain version ---------------------------------------
    check_comb_kernel(psa, cc, dev, max_err, plain_ms)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 11 done")

    # --- 12. comb kernel K5 vs plain version ---------------------------------------
    check_comb_rk45_kernel(psa, cca, dev, max_err, plain_ms, steps)
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 12 done")

    # --- 13. the comb main path ----------------------------------------------------
    nw = psa.nwave
    A0c, coc = comb_setup(psa)
    sub = slice(0, 8)
    co_sub = nw.NWaveCoeffs(gamma=coc.gamma[sub], alpha=coc.alpha[sub], beta_lin=coc.beta_lin)
    comb_paths = (("df32", "rk4", "comb_rk_f64", 1e-9), ("x32", "rk4", "comb_rk_f32", 1e-4),
                  ("x64", "rk45", "comb_rk45_f64", 1e-7), ("x32", "rk45", "comb_rk45_f32", 2e-2))
    refs = {}
    for precision, integ, name, bar in comb_paths:
        cfg = comb_cfg(psa, precision, integ)
        # the first call leaves the device out: the card is the default
        dev_kw = {} if name == "comb_rk_f64" else {"device": "cuda"}
        t0 = time.perf_counter()
        (P, A, ok), counts = run_main_path(psa, _build, name, lambda: nw.solve_comb_batch(
            cfg, coc, A0c, engine="auto", **dev_kw))
        sec = time.perf_counter() - t0
        if counts != {name: 1}:
            raise AssertionError(f"comb {precision} {integ}: launches {counts}, not one {name}")
        launches[name] = counts[name]
        if A.shape != (COMB_B, COMB_N) or not ok.all() or not np.isfinite(A).all():
            raise AssertionError(f"comb {precision} {integ}: shape {A.shape}, ok {ok.mean()}")
        if integ not in refs:
            ref_cfg = (comb_cfg(psa, "x64", "rk45", rtol=1e-11, atol=1e-14) if integ == "rk45"
                       else comb_cfg(psa, "x64"))
            t1 = time.perf_counter()
            refs[integ] = nw.solve_comb_batch(ref_cfg, co_sub, A0c[sub], coupling="fft",
                                              engine="torch", device="cpu")[1]
            log(f"plain fp64 {integ} reference on the CPU, 8 combs, fft coupling"
                f"{' at rtol 1e-11' if integ == 'rk45' else ''}: {time.perf_counter() - t1:.1f} s")
        P_ref = np.abs(refs[integ]) ** 2
        sig = P_ref > 1e-6
        err = float(np.max(np.abs(np.abs(A[sub][sig]) ** 2 / P_ref[sig] - 1.0)))
        log(f"main path comb {integ} {precision}: {COMB_B} combs of {COMB_N} lines, launches "
            f"{counts}, ok 1.0, {sec * 1e3:.1f} ms (first call); 8-comb subset vs plain fp64 "
            f"(CPU): max rel power err {err:.3e} on {int(sig.sum())} lines above 1e-6 W "
            f"(bar {bar:g})")
        if not err <= bar:
            raise AssertionError(f"comb {precision} {integ} subset error {err:.3e} > {bar:g}")

    c1 = nw.NWaveCoeffs(gamma=1e-2, alpha=5e-5, beta_lin=coc.beta_lin)
    t0 = time.perf_counter()
    z, A = nw.run_comb_simulation(comb_cfg(psa, "x64"), c1, A0c[0], device="cuda")
    sec = time.perf_counter() - t0
    z_c, A_c = nw.run_comb_simulation(comb_cfg(psa, "x64"), c1, A0c[0], device="cpu")
    err = float(np.max(np.abs(A - A_c)) / np.max(np.abs(A_c)))
    log(f"run_comb_simulation on the card (1,000 rk4 steps, fft coupling, plain torch): "
        f"{A.shape[0]} rows in {sec:.1f} s; vs the CPU {err:.3e} of the largest amplitude "
        "(bar 1e-11)")
    if not (A.shape == (COMB_STEPS // COMB_SAVE + 1, COMB_N) and np.array_equal(z, z_c)
            and err <= 1e-11):
        raise AssertionError(f"run_comb_simulation: shape {A.shape}, error {err:.3e}")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 13 done")

    # --- 14. comb times ------------------------------------------------------------
    L = cc.kernel_fft_len(COMB_N)
    comb_kw = dict(dz_m=COMB_Z / COMB_STEPS, n_steps=COMB_STEPS, save_every=COMB_SAVE)
    n_saves = COMB_STEPS // COMB_SAVE
    comb_flop = {}

    def comb_bounds(name, rdt, flop, nbytes):
        comb_flop[name] = flop
        bound(name, rdt, flop, nbytes)

    for rdt in (torch.float64, torch.float32):
        name = f"comb_rk_{suffix(rdt)}"
        t = comb_lanes(psa, rdt, dev)
        ms[name] = 1e3 * timed(lambda: cc.solve_comb_batch_cuda(*t, **comb_kw, integrator="rk4"))
        # inputs: A0 (2N), gamma, alpha, beta (N), the float64 twiddles;
        # outputs: P_max (N), A_end (2N), ok (1 byte)
        comb_bounds(name, rdt, COMB_B * (
            COMB_STEPS * comb_step_flop(COMB_N, L, "rk4", rdt) + n_saves * 3 * COMB_N),
            COMB_B * ((6 * COMB_N + 2) * rdt.itemsize + 1) + 2 * L * 8)
    for rdt in (torch.float64, torch.float32):
        name = f"comb_rk45_{suffix(rdt)}"
        rtol, atol = COMB_TOL[rdt]
        t = comb_lanes(psa, rdt, dev)
        kw45 = dict(comb_kw, rtol=rtol, atol=atol)
        r = cca.solve_comb_batch_rk45_cuda(*t, **kw45)
        attempts = float((r.n_accepted + r.n_rejected).double().sum())
        ms[name] = 1e3 * timed(lambda: cca.solve_comb_batch_rk45_cuda(*t, **kw45))
        # this run's attempts; each comb adds its first RHS and the saves;
        # outputs add the two int32 counters; the twiddles are float64
        comb_bounds(name, rdt, attempts * comb_attempt_flop(COMB_N, L)
                    + COMB_B * (comb_rhs_flop(COMB_N, L) + n_saves * 3 * COMB_N),
                    COMB_B * ((6 * COMB_N + 2) * rdt.itemsize + 9) + 2 * L * 8)
        steps[name + "_timed"] = (attempts / COMB_B, int((r.n_accepted + r.n_rejected).max()))
    comb_e2e, library_ms = {}, {}
    for precision, integ, name, _bar in comb_paths:
        cfg = comb_cfg(psa, precision, integ)
        comb_e2e[f"{integ} {precision}"] = timed(lambda: nw.solve_comb_batch(
            cfg, coc, A0c, device="cuda"))
        # the library call: the same integration through torch.fft (the
        # 'fft' coupling's cuFFT transforms), plain torch on the card
        library_ms[name] = 1e3 * timed(lambda: nw.solve_comb_batch(
            cfg, coc, A0c, coupling="fft", engine="torch", device="cuda"))
    log(f"comb times on {card} (median of {REPS} warm reps, host clock with synchronize; "
        f"bound: FFT count at FP64 {PEAK_FLOPS[torch.float64] / 1e12:g} / FP32 "
        f"{PEAK_FLOPS[torch.float32] / 1e12:g} TFLOP/s; {PEAK_BYTES / 1e12:g} TB/s):")
    for name in ("comb_rk_f64", "comb_rk_f32", "comb_rk45_f64", "comb_rk45_f32"):
        extra = ""
        if name + "_timed" in steps:
            mean, mx = steps[name + "_timed"]
            extra += f"; attempted steps per comb mean {mean:.1f}, max {mx}"
        log(f"  {name} {COMB_B} combs: {ms[name]:.3f} ms = "
            f"{COMB_B * COMB_STEPS / ms[name] * 1e3:.1f} comb-steps/s; bound {bound_ms[name]:.3f} "
            f"ms ({bound_by[name]}; {comb_flop[name]:.4g} flop, {bytes_of[name]} bytes; "
            f"the kernel at {100 * bound_ms[name] / ms[name]:.2f}% of it)"
            f"{extra}; solve_comb_batch with the fft coupling in plain torch (the library call) "
            f"{library_ms[name]:.3f} ms; plain version on the card "
            f"(one run, phase 11/12) {plain_ms[name]:.1f} ms")
    for label, sec in comb_e2e.items():
        log(f"  solve_comb_batch end to end, {label}, {COMB_B} combs: {sec * 1e3:.3f} ms = "
            f"{COMB_B / sec:.1f} combs/s")
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 14 done")

    rec = dict(max_err=max_err, plain_ms=plain_ms, steps=steps, launches=launches, ms=ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes_of=bytes_of, library_ms=library_ms)
    gnlse_phases(psa, _build, cg, csa, dev, card, t_start, rec)
    lle_phases(psa, _build, cl, csa, dev, card, t_start, rec)
    vgnlse_phases(psa, _build, cv, cg, dev, card, t_start, rec)
    log(f"[{time.perf_counter() - t_start:.0f} s] all phases done")

    sources = {"fwm4_rk": f"{PKG}/csrc/fwm4_rk.cu", "fwm4_rk45": f"{PKG}/csrc/fwm4_rk45.cu",
               "comb_rk": f"{PKG}/csrc/comb_rk.cu", "comb_rk45": f"{PKG}/csrc/comb_rk45.cu",
               "gnlse_ssfm": f"{PKG}/csrc/gnlse_ssfm.cu", "ssfm_rk45": f"{PKG}/csrc/ssfm_rk45.cu",
               "lle_ssfm": f"{PKG}/csrc/lle_ssfm.cu", "ssfm_rk45_lle": f"{PKG}/csrc/ssfm_rk45.cu",
               "vgnlse_ssfm": f"{PKG}/csrc/vgnlse_ssfm.cu",
               "gnlse_ssfm_nl": f"{PKG}/csrc/gnlse_ssfm.cu",
               "vgnlse_ssfm_coherent": f"{PKG}/csrc/vgnlse_ssfm.cu",
               "vgnlse_ssfm_nl": f"{PKG}/csrc/vgnlse_ssfm.cu"}
    replaces = {
        "fwm4_rk_f64": f"{JAX_PKG}/ops/pallas_df32.py:442",
        "fwm4_rk_f32": f"{JAX_PKG}/ops/pallas_solver.py:300",
        "fwm4_rk45_f64": f"{JAX_PKG}/ops/pallas_adaptive.py:67",
        "fwm4_rk45_f32": f"{JAX_PKG}/ops/pallas_adaptive.py:67",
        "comb_rk_f64": f"{JAX_PKG}/ops/pallas_comb.py:97",
        "comb_rk_f32": f"{JAX_PKG}/ops/pallas_comb.py:97",
        "comb_rk45_f64": f"{JAX_PKG}/ops/pallas_comb_adaptive.py:77",
        "comb_rk45_f32": f"{JAX_PKG}/ops/pallas_comb_adaptive.py:77",
        "gnlse_ssfm_f64": f"{JAX_PKG}/ops/pallas_gnlse.py:360",
        "gnlse_ssfm_f32": f"{JAX_PKG}/ops/pallas_gnlse.py:360",
        "ssfm_rk45_f64": f"{JAX_PKG}/ops/pallas_ssfm_adaptive.py:101",
        "ssfm_rk45_f32": f"{JAX_PKG}/ops/pallas_ssfm_adaptive.py:101",
        "lle_ssfm_f64": f"{JAX_PKG}/ops/pallas_lle.py:47",
        "lle_ssfm_f32": f"{JAX_PKG}/ops/pallas_lle.py:47",
        "ssfm_rk45_lle_f64": f"{JAX_PKG}/ops/pallas_ssfm_adaptive.py:101",
        "ssfm_rk45_lle_f32": f"{JAX_PKG}/ops/pallas_ssfm_adaptive.py:101",
        "vgnlse_ssfm_f64": f"{JAX_PKG}/ops/pallas_vgnlse.py:58",
        "vgnlse_ssfm_f32": f"{JAX_PKG}/ops/pallas_vgnlse.py:58",
        "gnlse_ssfm_nl_f64": f"{JAX_PKG}/ops/pallas_gnlse.py:360",
        "gnlse_ssfm_nl_f32": f"{JAX_PKG}/ops/pallas_gnlse.py:360",
        "vgnlse_ssfm_coherent_f64": f"{JAX_PKG}/ops/pallas_vgnlse.py:58",
        "vgnlse_ssfm_coherent_f32": f"{JAX_PKG}/ops/pallas_vgnlse.py:58",
        "vgnlse_ssfm_nl_f64": f"{JAX_PKG}/ops/pallas_vgnlse.py:58",
        "vgnlse_ssfm_nl_f32": f"{JAX_PKG}/ops/pallas_vgnlse.py:58",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name.rsplit("_", 1)[0]],
         "replaces": replaces[name], "launches": launches[name], "max_abs_err": max_err[name],
         "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound_ms[name],
         "bound_by": bound_by[name], "library_ms": library_ms.get(name)}
        for name in ("fwm4_rk_f64", "fwm4_rk_f32", "fwm4_rk45_f64", "fwm4_rk45_f32",
                     "comb_rk_f64", "comb_rk_f32", "comb_rk45_f64", "comb_rk45_f32",
                     "gnlse_ssfm_f64", "gnlse_ssfm_f32", "ssfm_rk45_f64", "ssfm_rk45_f32",
                     "lle_ssfm_f64", "lle_ssfm_f32", "ssfm_rk45_lle_f64", "ssfm_rk45_lle_f32",
                     "vgnlse_ssfm_f64", "vgnlse_ssfm_f32", "gnlse_ssfm_nl_f64",
                     "gnlse_ssfm_nl_f32", "vgnlse_ssfm_nl_f64", "vgnlse_ssfm_nl_f32",
                     "vgnlse_ssfm_coherent_f64", "vgnlse_ssfm_coherent_f32")
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
