#!/usr/bin/env python3
"""Why the float32 comb DP45 kernel K5 (``csrc/comb_rk45.cu``) and its plain
version parted at N = 1,100 lines, on one CUDA card.

Run from the root of a checkout:

    python3 chip_comb_rk45_probe.py [--out FILE]

The kernel and its plain version form a step's error norm and step factor
from the same float32 values; the question is whether the card's torch
rounds the scalar operations there as the kernel does.  The script prints:

1. over every float32 ``e`` in [2^-13, 2^11] (outside it the factor is
   clipped), the kernel's expressions built with the kernel's flags
   (``ops/_build``'s for ``comb_rk45``, ``-fmad=false``) into
   ``build/k5_probe/``: how many inputs give the kernel's
   ``pow(max(e, 1e-16), -1/5)`` and step factor another value than
   ``torch.pow`` (and than float64 ``pow`` rounded to float32), and how many
   give the kernel's ``e / T(n)`` (the norm's mean over n = 1,100 lines)
   another value than torch's ``e / n`` with n a Python number, and than
   ``e / torch.full_like(e, n)``;
2. the fp32 case of ``tests/test_torch_kernel.py::
   test_comb_rk45_kernel_matches_plain_version`` at N = 1,100 and 100 steps
   (37 combs 10 GHz apart, comb 7 blown up, steps of 5 m,
   ``save_every=10``, rtol 1e-6, atol 1e-10): kernel against the plain
   version on every comb, the combs whose counters or ``A_end`` differ, and
   whether all outputs agree bit for bit.

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

ROOT = Path(__file__).resolve().parent

FACTOR_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// csrc/comb_rk45.cu's step factor, its expression verbatim, the pow in it,
// and the mean of its error norm, sum / T(n), at n lines.
template <typename T>
__global__ void step_factor_kernel(const T* __restrict__ e, T* __restrict__ pw,
                                   T* __restrict__ fac, T* __restrict__ mean, int lines,
                                   int64_t n) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
    if (i >= n) return;
    const T enorm = e[i];
    pw[i] = pow(fmax(enorm, T(1e-16)), T(-1.0 / 5.0));
    fac[i] = fmin(fmax(T(0.9) * pow(fmax(enorm, T(1e-16)), T(-1.0 / 5.0)), T(0.2)), T(5));
    mean[i] = enorm / T(lines);
}

extern "C" int k5_step_factor_f32(const float* e, float* pw, float* fac, float* mean,
                                  int lines, int64_t n, void* stream) {
    const int nt = 256;
    const int64_t blocks = (n + nt - 1) / nt;
    step_factor_kernel<float><<<static_cast<unsigned>(blocks), nt, 0,
                                static_cast<cudaStream_t>(stream)>>>(e, pw, fac, mean, lines,
                                                                     n);
    return static_cast<int>(cudaGetLastError());
}
"""

N, B, BAD = 1100, 37, 7
DEV = "cuda"
KW = dict(dz_m=5.0, n_steps=100, save_every=10, rtol=1e-6, atol=1e-10)


def build_factor(_build):
    """The probe's library, built with comb_rk45.cu's flags."""
    out_dir = _build.BUILD_DIR.parent / "k5_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "k5_step_factor.cu", out_dir / "libk5_step_factor.so"
    src.write_text(FACTOR_SOURCE)
    flags = _build.NVCC_FLAGS + _build.SOURCE_FLAGS["comb_rk45"]
    proc = subprocess.run([_build.find_nvcc(), *flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the step factor:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).k5_step_factor_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return flags, fn


def kernel_factor(fn, e, lines=N):
    """(pow, factor, e / lines) of the kernel's expressions on the float32
    CUDA tensor e."""
    e = e.contiguous()
    pw, fac, mean = torch.empty_like(e), torch.empty_like(e), torch.empty_like(e)
    err = fn(e.data_ptr(), pw.data_ptr(), fac.data_ptr(), mean.data_ptr(), lines, e.numel(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"k5_step_factor_f32 launch failed: cudaError {err}")
    return pw, fac, mean


def sweep(fn, ad, lo=2.0 ** -13, hi=2.0 ** 11):
    """Every float32 in [lo, hi]: the inputs where the kernel's pow or factor
    differs from torch's and from float64 pow rounded to float32, and where
    the kernel's e / N differs from torch's e / N (a Python number) and from
    e / full_like(e, N)."""
    lo = int(np.float32(lo).view(np.int32))
    hi = int(np.float32(hi).view(np.int32))
    expo = float(np.float32(ad.ORDER_EXP))   # the kernel's T(-1.0 / 5.0)
    keys = ("pow_torch", "factor_torch", "pow_f64", "factor_f64", "mean_scalar", "mean_tensor")
    out = dict({"inputs": hi - lo + 1, "lines": N}, **{k: 0 for k in keys})
    step = 1 << 25
    for start in range(lo, hi + 1, step):
        bits = torch.arange(start, min(start + step, hi + 1), dtype=torch.int32, device=DEV)
        e = bits.view(torch.float32)
        kp, kf, km = kernel_factor(fn, e)
        c = torch.clamp_min(e, 1e-16)
        tp = torch.pow(c, ad.ORDER_EXP)
        dp = torch.pow(c.double(), expo).float()
        for key, a, b in (("pow_torch", kp, tp), ("pow_f64", kp, dp),
                          ("factor_torch", kf,
                           torch.clamp(ad.SAFETY * tp, ad.MIN_FACTOR, ad.MAX_FACTOR)),
                          ("factor_f64", kf,
                           torch.clamp(ad.SAFETY * dp, ad.MIN_FACTOR, ad.MAX_FACTOR)),
                          ("mean_scalar", km, e / N),
                          ("mean_tensor", km, e / torch.full_like(e, float(N)))):
            out[key] += int((a != b).sum())
    return out


def gaps(k, p):
    """Per comb: max_lines |k - p| / max_lines |p| of A_end."""
    return ((k.A_end - p.A_end).abs().amax(-1) / p.A_end.abs().amax(-1)).tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_comb_rk45_probe: torch.cuda.is_available() is False -- this script "
                 "runs the CUDA kernel and never runs on the CPU")
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_kernel import _comb_inputs
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import adaptive as ad
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb_adaptive as cca

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    _build.load_library("comb_rk45")
    flags, fn = build_factor(_build)
    out = {"card": card, "torch": torch.__version__, "flags": list(flags), "inputs":
           dict(KW, N=N, B=B, bad=BAD, spacing_hz=10e9)}

    # 1. the step factor and the mean on every float32 input that is not clipped
    out["sweep"] = sw = sweep(fn, ad)
    print(f"over {sw['inputs']} float32 inputs in [2^-13, 2^11]: the kernel's pow differs from "
          f"torch.pow on {sw['pow_torch']} (the factor on {sw['factor_torch']}), from float64 "
          f"pow rounded on {sw['pow_f64']} (the factor on {sw['factor_f64']}); the kernel's "
          f"e / T({N}) differs from torch's e / {N} on {sw['mean_scalar']} and from "
          f"e / full_like(e, {N}) on {sw['mean_tensor']}", flush=True)

    # 2. every comb: kernel against the package's plain version
    t = _comb_inputs(N, B, torch.float32, torch.device(DEV), bad=BAD, spacing_hz=10e9)
    rk = cca.solve_comb_batch_rk45_cuda(*t, **KW)
    rp = cca.solve_comb_batch_rk45_torch(*t, **KW)
    torch.cuda.synchronize()
    g = gaps(rk, rp)
    counts = [((int(rk.n_accepted[b]), int(rk.n_rejected[b])),
               (int(rp.n_accepted[b]), int(rp.n_rejected[b]))) for b in range(B)]
    out["parted"] = [{"comb": b, "kernel": counts[b][0], "plain": counts[b][1], "gap": g[b]}
                     for b in range(B) if g[b] != 0 or counts[b][0] != counts[b][1]]
    out["max_gap"] = max(g)
    out["bitwise"] = bool(torch.equal(rk.A_end, rp.A_end) and torch.equal(rk.P_max, rp.P_max)
                          and torch.equal(rk.ok, rp.ok)
                          and torch.equal(rk.n_accepted, rp.n_accepted)
                          and torch.equal(rk.n_rejected, rp.n_rejected))
    print(f"kernel vs plain, N = {N}, fp32, all {B} combs (comb {BAD} fails): max A_end gap "
          f"{out['max_gap']:.4e}, bit for bit (counters, ok, P_max, A_end): {out['bitwise']}; "
          f"combs that part: {len(out['parted'])}; comb {BAD}: kernel {counts[BAD][0]}, plain "
          f"{counts[BAD][1]} accepted/rejected", flush=True)

    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
