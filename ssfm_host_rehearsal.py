#!/usr/bin/env python3
"""Rehearse the LLE split-step kernels on the CPU, before a card is at hand.

Run from the root of a checkout on a machine with g++ (no card, no nvcc):

    python3 ssfm_host_rehearsal.py

It compiles ``csrc/gnlse_ssfm.cu`` and ``csrc/ssfm_rk45.cu`` as host C++
into ``build/host_rehearsal/``: a stub ``cuda_runtime.h`` defines the CUDA
qualifiers away, a block runs as one thread (``__syncthreads`` a no-op,
``__syncthreads_and(p)`` = p, ``__shfl_down_sync`` 0, ``__ldg`` a load),
``extern __shared__`` becomes a static buffer and each ``<<<...>>>`` launch
a loop over ``blockIdx.x``; ``-ffp-contract=off`` as torch's CPU kernels
round.  It then calls the LLE launchers (K7 ``lle_ssfm_*``, K8's LLE route
``ssfm_rk45_lle_*``) through ctypes with the arguments their wrappers pass,
on 5 soliton-ansatz cavities of 256 samples (a complex pump, one cavity
overflowing), shared and per-cavity phase, and prints each against its
plain version.  It cannot see what only the card's compiler refuses.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

import psa_torch as psa
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models.gnlse import save_segments
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops._build import CSRC_DIR
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.cuda_gnlse import twiddles

OUT = Path(__file__).resolve().parent / "build" / "host_rehearsal"
STUB = """#pragma once
#include <cmath>
#include <cstdint>
#include <cstddef>
using std::isfinite;
#define __global__
#define __device__
#define __host__
#define __launch_bounds__(x)
#define __align__(n) alignas(n)
struct HDim { int x; };
inline HDim blockIdx{0}, threadIdx{0}, blockDim{1};
alignas(64) inline unsigned char host_smem[300000];
inline void __syncthreads() {}
inline int __syncthreads_and(int p) { return p; }
template <typename T> inline T __shfl_down_sync(unsigned, T, int) { return T(0); }
struct double2 { double x, y; };
struct float2 { float x, y; };
inline double2 __ldg(const double2* p) { return *p; }
inline float2 __ldg(const float2* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
"""


def build(name):
    """Compile csrc/<name>.cu as host C++; return the loaded library."""
    (OUT / "inc").mkdir(parents=True, exist_ok=True)
    (OUT / "inc" / "cuda_runtime.h").write_text(STUB)
    src = (CSRC_DIR / f"{name}.cu").read_text()
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = host_smem;")
    src = re.sub(r"(\w+_kernel<T, \w+>)\s*<<<.*?>>>\(",
                 r"for (blockIdx.x = 0; blockIdx.x < B; ++blockIdx.x) \1(", src, flags=re.S)
    cpp, lib = OUT / f"{name}.cpp", OUT / f"lib{name}.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    f"-I{OUT / 'inc'}", f"-I{CSRC_DIR}", str(cpp), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def k7(lib, psi0, det, F, ph, dt, n_steps, save_every):
    """One call of lle_ssfm_* with the arguments of cuda_lle.solve_lle_batch_cuda."""
    B, T = psi0.shape
    rdt = psi0.real.dtype
    Lh, Lf, stride = cl.factor_rows(ph, dt, psi0)
    aff = cl.affine_scalars(det, F, dt).to(psi0.dtype).contiguous()
    pk, y, ok = torch.empty(B, dtype=rdt), torch.empty_like(psi0), torch.empty(B, dtype=torch.uint8)
    fn = getattr(lib, f"lle_ssfm_{'f64' if rdt == torch.float64 else 'f32'}")
    err = fn(ptr(psi0), ptr(Lh), ptr(Lf), stride, ptr(aff), ptr(twiddles(T, "cpu")), ptr(pk),
             ptr(y), ptr(ok), B, T, n_steps, save_every, ctypes.c_double(dt), None)
    if err:
        raise RuntimeError(f"lle_ssfm returned {err}")
    return pk, y, ok.bool()


def k8(lib, psi0, det, F, ph, dt, n_steps, save_every, rtol, atol, max_steps=20_000):
    """One call of ssfm_rk45_lle_* with the arguments of its wrapper."""
    B, T = psi0.shape
    rdt = psi0.real.dtype
    n_chunks, seg, z_end, has_tail = save_segments(dt, n_steps, save_every)
    pk, y, ok = torch.empty(B, dtype=rdt), torch.empty_like(psi0), torch.empty(B, dtype=torch.uint8)
    na, nr = torch.empty(B, dtype=torch.int32), torch.empty(B, dtype=torch.int32)
    fn = getattr(lib, f"ssfm_rk45_lle_{'f64' if rdt == torch.float64 else 'f32'}")
    d = ctypes.c_double
    err = fn(ptr(psi0), ptr(det), ptr(F), ptr(ph), 0 if ph.ndim == 1 else T,
             ptr(twiddles(T, "cpu")), ptr(pk), ptr(y), ptr(ok), ptr(na), ptr(nr), B, T, n_chunks,
             d(seg), d(z_end), int(has_tail), d(dt), d(rtol), d(atol), max_steps, None)
    if err:
        raise RuntimeError(f"ssfm_rk45_lle returned {err}")
    return pk, y, ok.bool(), na, nr


def normwise(a, b):
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def main():
    torch.set_num_threads(1)
    lib7, lib8 = build("gnlse_ssfm"), build("ssfm_rk45")
    grid = psa.lle.TimeGrid(n_samples=256, t_window_s=20.0)
    dets = np.linspace(3.5, 4.5, 5)
    co = psa.lle.make_lle_coeffs(grid, detuning=dets, pump=2.2 * np.exp(0.3j), d2=-1.0)
    seeds = np.stack([psa.lle.soliton_ansatz(grid, d, 2.2, -1.0) for d in dets])
    for rdt, cdt, bad in ((torch.float64, torch.complex128, 1e160),
                          (torch.float32, torch.complex64, 1e25)):
        for rows in (False, True):
            psi0 = seeds.copy()
            psi0[2] *= bad                   # |psi|^2 overflows the type
            det, F, ph = psa.lle.lane_coeffs(co, 5, 256, rdt, "cpu")
            if rows:
                ph = (ph[None] * torch.linspace(0.8, 1.2, 5, dtype=rdt)[:, None]).contiguous()
            y0 = torch.as_tensor(psi0).to(cdt)
            label = f"{str(rdt)[6:]} {'per-cavity' if rows else 'shared'} phase"
            for n_steps in (20, 23):
                pk, y, ok = k7(lib7, y0, det, F, ph, 0.01, n_steps, 4)
                r = cl.solve_lle_batch_torch(y0, det, F, ph, dt=0.01, n_steps=n_steps, save_every=4)
                g = r.ok
                print(f"K7 {label} {n_steps} steps: ok {ok.tolist() == r.ok.tolist()}, bad "
                      f"cavity frozen {torch.equal(y[2], y0[2])}, A_end "
                      f"{normwise(y[g], r.A_end[g]):.2e}, peak "
                      f"{float(((pk[g] - r.peak_max[g]) / r.peak_max[g]).abs().max()):.2e}")
            rtol, atol = (1e-8, 1e-11) if rdt == torch.float64 else (1e-5, 1e-8)
            for n_steps in (40, 43):
                pk, y, ok, na, nr = k8(lib8, y0, det, F, ph, 0.01, n_steps, 10, rtol, atol)
                r = csa.solve_lle_batch_rk45_torch(y0, det, F, ph, dt=0.01, n_steps=n_steps,
                                                   save_every=10, rtol=rtol, atol=atol)
                g = r.ok
                same = torch.equal(na, r.n_accepted) and torch.equal(nr, r.n_rejected)
                print(f"K8-LLE {label} {n_steps} steps: ok {ok.tolist() == r.ok.tolist()}, "
                      f"counters equal {same}, bad cavity rejected {int(nr[2])} times, A_end "
                      f"{normwise(y[g], r.A_end[g]):.2e}")


if __name__ == "__main__":
    main()
