#!/usr/bin/env python3
"""Rehearse the split-step kernels (K6 nl, K7, K8, K9), the comb kernels (K4,
K5) and the 4-wave kernels (K1/K2, K3) on the CPU, before a card is at hand,
with a block's threads run as host threads.

Run from the root of a checkout on a machine with g++ (C++20; no card, no
nvcc):

    python3 ssfm_host_rehearsal.py

It compiles ``csrc/gnlse_ssfm.cu``, ``csrc/lle_ssfm.cu``,
``csrc/ssfm_rk45.cu``, ``csrc/vgnlse_ssfm.cu``, ``csrc/comb_rk.cu``,
``csrc/comb_rk45.cu``, ``csrc/fwm4_rk.cu`` and ``csrc/fwm4_rk45.cu`` as
host C++ into
``build/host_rehearsal/``.  A stub ``cuda_runtime.h`` defines the CUDA
qualifiers away and runs each block of a ``<<<grid, block, ...>>>`` launch as
``block`` ``std::thread``s, one block after another: ``threadIdx`` is
thread-local, ``__syncthreads`` waits at a C++20 ``std::barrier`` of the
block's threads, ``__syncthreads_and`` ANDs its argument over them at that
barrier; each group of 32 threads is a warp with a barrier of its own:
``__syncwarp`` waits there, ``__all_sync`` ANDs over the warp, and
``__shfl_down_sync`` and ``__shfl_xor_sync`` exchange through the warp's
array between two warp barriers, as does ``__shfl_sync`` within segments
of its width, and ``__any_sync`` ORs over the warp; a thread that returns
drops out of its warp's barrier; ``__ldg`` is a load and ``extern __shared__`` one static buffer; ``__fmul_rn`` and
``__dmul_rn`` are products; the card reports ``host_sm_count`` SMs (132, an
H100's, unless a caller sets it: :func:`sm_count`); ``-ffp-contract=off`` as
torch's CPU kernels round.  So the threads' ownership of samples and the barriers between passes
are rehearsed: a missing barrier shows as a wrong or varying result.  It
then calls the launchers through ctypes with the arguments their wrappers
pass and prints each against its plain version:

- K6 nl (``gnlse_ssfm_*`` with ``use_nl``): 5 sech envelopes at T = 256,
  384 (r = 3) and 640 (r = 5), Raman and steepening, Raman only and
  steepening only, one envelope overflowing, 12 steps and 14 (a trailing
  partial chunk at ``save_every=4``), fp64 and fp32;
- K9 (``vgnlse_ssfm_*``): 5 two-polarization pulses, the nl body at T =
  256, 384 and 640, the rotation and coherent bodies at 256 and 384, shared
  and per-instance factor planes, one instance overflowing, 12 and 14 steps;
- K7 (``lle_ssfm_*``) on 5 soliton-ansatz cavities of 256, 384 (r = 3),
  512, 1,024 and 2,048 (8 samples a thread) samples (a complex pump, one
  cavity overflowing), shared and per-cavity phase, 20 and 23 steps at
  ``save_every=4``; K8's LLE route (``ssfm_rk45_lle_*``) on the 256-sample
  cavities;
- K8's GNLSE route (``ssfm_rk45_*``) on 5 sech envelopes at T = 256 and 384,
  one 1e12 times too strong;
- K4 (``comb_*``): rk4, ab4 and abm4 at N = 16, 33, 64 (one warp a comb)
  and 100 (a block of 64 threads), one comb blowing up, fp64 and fp32;
- K5 (``comb_rk45_*``) at the same widths, 105 steps at ``save_every=10``,
  fp64 at rtol 1e-9 and fp32 at 1e-6, the step counters beside the plain
  version's, the failed comb's accepted steps and state; in fp32 also both
  solutions against the plain fp64 version at the same rtol (the plain
  versions with the host build's ``sqrt`` and ``pow``, :func:`host_libm`);
  and the error norm of the failed 16-line comb's attempt at the smallest
  step, float32 (the kernels' coupling, dense DFT, FFT, the RHS in float64)
  and float64;
- K1/K2 (``fwm4_*``) rk4, ab4 and abm4 and K3 (``fwm4_rk45_*``) on 130
  lanes of the 4-wave bench powers, delta beta over [-1.66, 1.5] /m, one
  lane blowing up, 253 steps at ``save_every=7`` (K3 in steps of 2^-5 m,
  rtol 1e-10 / 1e-6, a lane over 4 threads and over one: the stub's card
  with 132 SMs and with 0), fp64 and fp32.

It cannot see what only the card's compiler refuses, nor the card's
scheduling.

``--readings`` prints instead the CPU readings of the plain vector version
at ``chip_smoke.py``'s vector configuration (8 instances): the plain fp32
version and the plain version with gamma 0.1% off against the plain fp64
version, the readings the fp32 bars of the card check are set from.
"""

import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import psa_torch as psa
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models.gnlse import save_segments
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive as ca
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb as cc
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb_adaptive as cca
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_solver as cs
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_vgnlse as cv
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops._build import CSRC_DIR
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.cuda_adaptive import kernel_segments
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.cuda_gnlse import twiddles

OUT = Path(__file__).resolve().parent / "build" / "host_rehearsal"
STUB = """#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
using std::fma;
using std::fmax;
using std::fmin;
using std::isfinite;
using std::pow;
using std::sqrt;
#define __global__
#define __device__
#define __host__
#define __launch_bounds__(...)
#define __forceinline__ inline
#define __align__(n) alignas(n)
struct HDim { int x; };
inline thread_local HDim threadIdx{0};
inline HDim blockIdx{0}, blockDim{1};
alignas(64) inline unsigned char host_smem[400000];
struct HostBlock {
    std::atomic<int> acc{1};  // the AND of __syncthreads_and's arguments
    int res = 1;
};
inline HostBlock hb;
struct BarrierDone {
    void operator()() noexcept { hb.res = hb.acc.load(); hb.acc.store(1); }
};
inline std::barrier<BarrierDone>* hbar = nullptr;
inline void __syncthreads() { hbar->arrive_and_wait(); }
inline int __syncthreads_and(int p) {
    if (!p) hb.acc.store(0);
    hbar->arrive_and_wait();
    return hb.res;
}
// One warp: its barrier (__syncwarp), the AND of __all_sync's arguments and
// the shuffles' exchange, lane-indexed.
struct HostWarp;
struct WarpDone {
    HostWarp* w;
    void operator()() noexcept;
};
struct HostWarp {
    std::atomic<int> acc{1};
    int res = 1;
    double xch[2][32];
    std::barrier<WarpDone>* bar = nullptr;
};
inline HostWarp hwarp[32];
inline void WarpDone::operator()() noexcept { w->res = w->acc.load(); w->acc.store(1); }
inline void __syncwarp(unsigned = 0xffffffffu) { hwarp[threadIdx.x >> 5].bar->arrive_and_wait(); }
inline int __all_sync(unsigned, int p) {
    HostWarp& w = hwarp[threadIdx.x >> 5];
    if (!p) w.acc.store(0);
    w.bar->arrive_and_wait();
    return w.res;
}
// Each thread of a warp makes the same shuffles in the same order, so they
// alternate between two exchange arrays: a thread can write the next one
// only after every thread has arrived at this one's barrier, past its read
// of the array before.
inline thread_local unsigned host_shfl_count = 0;
template <typename T, class Src> inline T host_shfl(T v, Src src) {
    const int l = threadIdx.x & 31;
    HostWarp& w = hwarp[threadIdx.x >> 5];
    double* xch = w.xch[host_shfl_count++ & 1];
    xch[l] = double(v);
    __syncwarp();
    const int from = src(l);
    return from >= 0 && from < 32 ? T(xch[from]) : v;
}
template <typename T> inline T __shfl_down_sync(unsigned, T v, int o) {
    return host_shfl(v, [o](int l) { return l + o; });
}
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int m) {
    return host_shfl(v, [m](int l) { return l ^ m; });
}
template <typename T> inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
    return host_shfl(v, [src, width](int l) { return (l & ~(width - 1)) + (src & (width - 1)); });
}
inline int __any_sync(unsigned m, int p) { return !__all_sync(m, !p); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
template <class F> inline void host_launch(int grid, int block, F f) {
    blockDim.x = block;
    const int warps = (block + 31) / 32;
    for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        std::barrier<BarrierDone> bar(block);
        hbar = &bar;
        std::vector<std::unique_ptr<std::barrier<WarpDone>>> wbar;
        for (int w = 0; w < warps; ++w) {
            const int size = block - 32 * w < 32 ? block - 32 * w : 32;
            wbar.emplace_back(new std::barrier<WarpDone>(size, WarpDone{&hwarp[w]}));
            hwarp[w].bar = wbar.back().get();
        }
        std::vector<std::thread> ts;
        // a thread that returns leaves its warp's barrier, as an exited
        // thread leaves a warp's collective operations on the card
        for (int t = 0; t < block; ++t)
            ts.emplace_back([&f, t] {
                threadIdx.x = t;
                host_shfl_count = 0;
                f();
                hwarp[t >> 5].bar->arrive_and_drop();
            });
        for (auto& th : ts) th.join();
    }
}
struct double2 { double x, y; };
struct float2 { float x, y; };
inline double2 __ldg(const double2* p) { return *p; }
inline float2 __ldg(const float2* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
template <typename F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
// The SM count the stub's card reports (an H100 SXM's); a caller may set it.
extern "C" {
int host_sm_count = 132;
}
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
    *v = attr == cudaDevAttrMultiProcessorCount ? host_sm_count : 0;
    return 0;
}
"""
LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\((.*?)\);", re.S)


def split_top(text):
    """Split ``text`` at the commas outside brackets."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<[{"
        depth -= ch in ")>]}"
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def host_source(src):
    """A .cu source as host C++: the shared buffer static, each launch a
    host_launch of its grid and block."""
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = host_smem;")

    def launch(m):
        grid, block = split_top(m.group(2))[:2]
        return f"host_launch({grid}, {block}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    return LAUNCH.sub(launch, src)


def build(name, out=OUT):
    """Compile csrc/<name>.cu as host C++ in ``out``; return the loaded
    library."""
    (out / "inc").mkdir(parents=True, exist_ok=True)
    (out / "inc" / "cuda_runtime.h").write_text(STUB)
    cpp, lib = out / f"{name}.cpp", out / f"lib{name}.so"
    cpp.write_text(host_source((CSRC_DIR / f"{name}.cu").read_text()))
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{out / 'inc'}", f"-I{CSRC_DIR}", str(cpp), "-o", str(lib)],
                   check=True)
    return ctypes.CDLL(str(lib))


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@contextlib.contextmanager
def host_libm():
    """Within the block, ``torch.sqrt`` and ``torch.pow`` of CPU tensors give
    what the host build's ``std::sqrt`` and ``std::pow`` give: the correctly
    rounded square root (numpy's) and the C library's ``powf``/``pow``, one
    element at a time.  torch's own CPU ``sqrt`` and ``pow`` are vectorized
    approximations that differ from both in the last bit, where on the card
    torch and the kernels call the same device functions.  The adaptive
    plain versions then take the host build's steps in float32 too, whose
    error estimate is mostly rounding noise."""
    libm = ctypes.CDLL("libm.so.6")
    fns = {}
    for name, typ in (("powf", ctypes.c_float), ("pow", ctypes.c_double)):
        fn = getattr(libm, name)
        fn.argtypes, fn.restype = [typ, typ], typ
        fns[name] = fn
    sqrt, pow_ = torch.sqrt, torch.pow

    def host_sqrt(x):
        return torch.from_numpy(np.sqrt(x.numpy())) if x.device.type == "cpu" else sqrt(x)

    def host_pow(x, e):
        if x.device.type != "cpu" or isinstance(e, torch.Tensor):
            return pow_(x, e)
        fn = fns["powf" if x.dtype == torch.float32 else "pow"]
        return torch.tensor([fn(v, e) for v in x.flatten().tolist()],
                            dtype=x.dtype).reshape(x.shape)

    torch.sqrt, torch.pow = host_sqrt, host_pow
    try:
        yield
    finally:
        torch.sqrt, torch.pow = sqrt, pow_


def k6(lib, y0, gamma, alpha, ph, nl, dz, n_steps, save_every):
    """One call of gnlse_ssfm_* with the arguments of
    cuda_gnlse.solve_gnlse_batch_cuda."""
    B, T = y0.shape
    rdt = y0.real.dtype
    Lh, Lf, stride = cg.factor_planes(alpha, ph, dz, y0)
    tw = twiddles(T, "cpu")
    if nl is None:
        hrc, om, f_r, inv_w0 = tw, tw, 0.0, 0.0
    else:
        hrc = torch.complex(nl.hr_re, -nl.hr_im).contiguous()
        om, f_r, inv_w0 = nl.omega.contiguous(), float(nl.f_r), float(nl.inv_w0)
    pk, y, ok = torch.empty(B, dtype=rdt), torch.empty_like(y0), torch.empty(B, dtype=torch.uint8)
    fn = getattr(lib, f"gnlse_ssfm_{'f64' if rdt == torch.float64 else 'f32'}")
    d = ctypes.c_double
    err = fn(ptr(y0), ptr(Lh), ptr(Lf), stride, ptr(gamma), ptr(tw), ptr(hrc), ptr(om), ptr(pk),
             ptr(y), ptr(ok), B, T, n_steps, save_every, int(nl is not None), d(dz), d(f_r),
             d(inv_w0), None)
    if err:
        raise RuntimeError(f"gnlse_ssfm returned {err}")
    return pk, y, ok.bool()


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
    return _k8(lib, "ssfm_rk45_lle", psi0, det, F, ph, dt, n_steps, save_every, rtol, atol,
               max_steps)


def k8_gnlse(lib, y0, gamma, alpha, ph, dz, n_steps, save_every, rtol, atol, max_steps=20_000):
    """One call of ssfm_rk45_* (the GNLSE route) with the arguments of its
    wrapper."""
    return _k8(lib, "ssfm_rk45", y0, gamma, alpha, ph, dz, n_steps, save_every, rtol, atol,
               max_steps)


def _k8(lib, route, y0, p0, p1, ph, dt, n_steps, save_every, rtol, atol, max_steps):
    B, T = y0.shape
    rdt = y0.real.dtype
    n_chunks, seg, z_end, has_tail = save_segments(dt, n_steps, save_every)
    pk, y, ok = torch.empty(B, dtype=rdt), torch.empty_like(y0), torch.empty(B, dtype=torch.uint8)
    na, nr = torch.empty(B, dtype=torch.int32), torch.empty(B, dtype=torch.int32)
    fn = getattr(lib, f"{route}_{'f64' if rdt == torch.float64 else 'f32'}")
    d = ctypes.c_double
    err = fn(ptr(y0), ptr(p0), ptr(p1), ptr(ph), 0 if ph.ndim == 1 else T,
             ptr(twiddles(T, "cpu")), ptr(pk), ptr(y), ptr(ok), ptr(na), ptr(nr), B, T, n_chunks,
             d(seg), d(z_end), int(has_tail), d(dt), d(rtol), d(atol), max_steps, None)
    if err:
        raise RuntimeError(f"{route} returned {err}")
    return pk, y, ok.bool(), na, nr


def k1(lib, A0, gamma, alpha, delta_beta, dz, n_steps, save_every, method="rk4",
       check_nan=True):
    """One call of fwm4_<method>_* with the arguments of
    cuda_solver.solve_batch_cuda; returns its ``KernelBatchResult``."""
    B = A0.shape[0]
    rdt = A0.real.dtype
    coef = torch.stack([gamma, alpha, delta_beta])
    y0 = torch.cat([A0.real.T, A0.imag.T]).contiguous()
    pmax, y_last = torch.empty((4, B), dtype=rdt), torch.empty((8, B), dtype=rdt)
    ok = torch.empty(B, dtype=torch.uint8)
    fn = getattr(lib, f"fwm4_{method}_{'f64' if rdt == torch.float64 else 'f32'}")
    err = fn(ptr(coef), ptr(y0), ptr(pmax), ptr(y_last), ptr(ok), B, n_steps, save_every,
             int(check_nan), ctypes.c_double(dz), None)
    if err:
        raise RuntimeError(f"fwm4_{method} returned {err}")
    A_rot = torch.complex(y_last[:4].T, y_last[4:].T).contiguous()
    return cs.KernelBatchResult(
        P_max=pmax.T, ok=ok.bool(),
        A_end=cs._to_lab(A_rot, delta_beta, dz_m=dz, n_steps=n_steps, save_every=save_every))


def k3(lib, A0, gamma, alpha, delta_beta, dz, n_steps, save_every, rtol, atol,
       max_steps=1_000_000):
    """One call of fwm4_rk45_* with the arguments of
    cuda_adaptive.solve_batch_rk45_cuda; returns its ``AdaptiveBatchResult``."""
    B = A0.shape[0]
    rdt = A0.real.dtype
    n_chunks, seg_len, tail_len, dt0 = kernel_segments(dz, n_steps, save_every)
    coef = torch.stack([gamma, alpha, delta_beta])
    y0 = torch.cat([A0.real.T, A0.imag.T]).contiguous()
    pmax, y_last = torch.empty((4, B), dtype=rdt), torch.empty((8, B), dtype=rdt)
    ok = torch.empty(B, dtype=torch.uint8)
    na, nr = torch.empty(B, dtype=torch.int32), torch.empty(B, dtype=torch.int32)
    fn = getattr(lib, f"fwm4_rk45_{'f64' if rdt == torch.float64 else 'f32'}")
    d = ctypes.c_double
    err = fn(ptr(coef), ptr(y0), ptr(pmax), ptr(y_last), ptr(ok), ptr(na), ptr(nr), B, n_chunks,
             d(seg_len), d(tail_len), d(dt0), d(rtol), d(atol), max_steps, None)
    if err:
        raise RuntimeError(f"fwm4_rk45 returned {err}")
    A_rot = torch.complex(y_last[:4].T, y_last[4:].T).contiguous()
    return ca.AdaptiveBatchResult(
        P_max=pmax.T, ok=ok.bool(), n_accepted=na, n_rejected=nr,
        A_end=cs._to_lab(A_rot, delta_beta, dz_m=dz, n_steps=n_steps, save_every=save_every))


@contextlib.contextmanager
def sm_count(lib, n):
    """Within the block, the stub's card reports ``n`` SMs to ``lib``'s
    launchers (which pick a lane's threads from the batch and the SM
    count)."""
    v = ctypes.c_int.in_dll(lib, "host_sm_count")
    old, v.value = v.value, n
    try:
        yield
    finally:
        v.value = old


def fwm4_lanes(B, rdt, bad=7):
    """``B`` lanes of the 4-wave bench configuration's powers (0.5 W pumps,
    1e-7 W signal and idler), gamma 0.0115 /W/m, alpha 1.15e-4 /m, delta
    beta spread over [-1.66, 1.5] /m; lane ``bad`` blows up."""
    A0 = np.broadcast_to(np.sqrt([0.5, 0.5, 1e-7, 1e-7]).astype(np.complex128), (B, 4)).copy()
    g, a = np.full(B, 0.0115), np.full(B, 1.15e-4)
    A0[bad], g[bad] = [1e4, 1e4, 1.0, 0.0], 1e3
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return (torch.as_tensor(A0).to(cdt),
            *(torch.as_tensor(v, dtype=rdt) for v in (g, a, np.linspace(-1.66, 1.5, B))))


def k4(lib, A0, gamma, alpha, beta, dz, n_steps, save_every, method="rk4", check_nan=True):
    """One call of comb_<method>_* with the arguments of
    cuda_comb.solve_comb_batch_cuda."""
    B, N = A0.shape
    rdt = A0.real.dtype
    L = cc.kernel_fft_len(N)
    tw = cc.twiddles(L, torch.float64, "cpu")
    y0 = torch.cat([A0.real, A0.imag], dim=1).contiguous()
    pmax, y_last = torch.empty((B, N), dtype=rdt), torch.empty((B, 2 * N), dtype=rdt)
    ok = torch.empty(B, dtype=torch.uint8)
    fn = getattr(lib, f"comb_{method}_{'f64' if rdt == torch.float64 else 'f32'}")
    err = fn(ptr(gamma), ptr(alpha), ptr(beta), ptr(tw), ptr(y0), ptr(pmax), ptr(y_last), ptr(ok),
             B, N, L, n_steps, save_every, int(check_nan), ctypes.c_double(dz), None)
    if err:
        raise RuntimeError(f"comb_{method} returned {err}")
    return pmax, torch.complex(y_last[:, :N], y_last[:, N:]), ok.bool()


def k5(lib, A0, gamma, alpha, beta, dz, n_steps, save_every, rtol, atol, max_steps=10_000):
    """One call of comb_rk45_* with the arguments of
    cuda_comb_adaptive.solve_comb_batch_rk45_cuda; returns ``(P_max, A_end,
    ok, n_accepted, n_rejected)``."""
    B, N = A0.shape
    rdt = A0.real.dtype
    L = cc.kernel_fft_len(N)
    n_chunks, seg_len, tail_len, dt0 = kernel_segments(dz, n_steps, save_every)
    y0 = torch.cat([A0.real, A0.imag], dim=1).contiguous()
    pmax, y_last = torch.empty((B, N), dtype=rdt), torch.empty((B, 2 * N), dtype=rdt)
    ok = torch.empty(B, dtype=torch.uint8)
    na, nr = torch.empty(B, dtype=torch.int32), torch.empty(B, dtype=torch.int32)
    fn = getattr(lib, f"comb_rk45_{'f64' if rdt == torch.float64 else 'f32'}")
    d = ctypes.c_double
    err = fn(ptr(gamma), ptr(alpha), ptr(beta), ptr(cc.twiddles(L, torch.float64, "cpu")),
             ptr(y0), ptr(pmax), ptr(y_last), ptr(ok), ptr(na), ptr(nr), B, N, L, n_chunks,
             d(seg_len), d(tail_len), d(dt0), d(rtol), d(atol), max_steps, None)
    if err:
        raise RuntimeError(f"comb_rk45 returned {err}")
    return pmax, torch.complex(y_last[:, :N], y_last[:, N:]), ok.bool(), na, nr


def k9(lib, y0, gamma, alpha, b, ph, coherent, nl, dz, n_steps, save_every):
    """One call of vgnlse_ssfm_* with the arguments of
    cuda_vgnlse.solve_vgnlse_batch_cuda."""
    B, _, T = y0.shape
    rdt = y0.real.dtype
    Lh, Lf, stride = cv.factor_planes(alpha, ph, dz, y0)
    tw = twiddles(T, "cpu")
    if nl is None:
        hrc, om, f_r, inv_w0 = tw, tw, 0.0, 0.0
    else:
        hrc = torch.complex(nl.hr_re, -nl.hr_im).contiguous()
        om, f_r, inv_w0 = nl.omega.contiguous(), float(nl.f_r), float(nl.inv_w0)
    pk, y = torch.empty((B, 2), dtype=rdt), torch.empty_like(y0)
    ok = torch.empty(B, dtype=torch.uint8)
    fn = getattr(lib, f"vgnlse_ssfm_{'f64' if rdt == torch.float64 else 'f32'}")
    d = ctypes.c_double
    err = fn(ptr(y0), ptr(Lh), ptr(Lf), stride, ptr(gamma), ptr(tw), ptr(hrc), ptr(om), ptr(pk),
             ptr(y), ptr(ok), B, T, n_steps, save_every, cv.BODIES[cv.body_of(coherent, nl)],
             d(dz), d(float(b)), d(coherent), d(f_r), d(inv_w0), None)
    if err:
        raise RuntimeError(f"vgnlse_ssfm returned {err}")
    return pk, y, ok.bool()


def normwise(a, b):
    dims = tuple(range(1, a.ndim))
    return float(((a - b).abs().amax(dims) / b.abs().amax(dims)).max())


def vector_pulses(grid, B, theta=0.4):
    """Sech pulses at 0.5-1.0 x the soliton power (the first half of
    bench_gnlse.py's 0.5-1.5 ramp over 2B envelopes) split at theta."""
    P0 = psa.gnlse.soliton_peak_power(-2e-26, 2e-3, 1e-12)
    A = (np.sqrt(np.linspace(0.5, 1.5, 2 * B)[:B] * P0)[:, None]
         / np.cosh(grid.t()[None, :] / 1e-12))
    return np.stack([np.cos(theta) * A, np.sin(theta) * A], axis=1).astype(np.complex128)


def scalar_nl(lib6):
    """K6 nl against its plain version, fp64 and fp32."""
    gn = psa.gnlse
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    P0 = gn.soliton_peak_power(-2e-26, 2e-3, 1e-12)
    for n in (256, 384, 640):
        grid = gn.TimeGrid.for_pulse(1e-12, n_samples=n)
        A0 = np.sqrt(np.linspace(0.5, 1.5, 5) * P0)[:, None] / np.cosh(grid.t()[None, :] / 1e-12)
        co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=2e-3, alpha_1_m=5e-5)
        for f_r, w0 in ((0.18, 1.2e15), (0.18, None), (0.0, 1.2e15)):
            nl = gn.make_nl_terms(grid, f_raman=f_r, omega0=w0)
            for rdt, cdt in ((torch.float64, torch.complex128), (torch.float32, torch.complex64)):
                gamma, alpha, ph = gn.lane_coeffs(co, 5, n, rdt, "cpu")
                alpha = alpha.clone()
                alpha[2] = -4e6 if rdt == torch.float64 else -4e4  # overflows in a chunk
                nl_t = gn._cast_nl(nl, rdt, "cpu")
                y0 = torch.as_tensor(A0.astype(np.complex128)).to(cdt)
                for n_steps in (12, 14):
                    pk, y, ok = k6(lib6, y0, gamma, alpha, ph, nl_t, 0.02, n_steps, 4)
                    r = cg.solve_gnlse_batch_torch(y0, gamma, alpha, ph, dz_m=0.02,
                                                   n_steps=n_steps, save_every=4, nl=nl_t)
                    g = r.ok
                    e_pk = float(((pk[g] - r.peak_max[g]) / r.peak_max[g]).abs().max())
                    print(f"K6 nl n={n} f_R={f_r} {'steep' if w0 else 'no steep'} "
                          f"{str(rdt)[6:]} {n_steps} steps: ok {ok.tolist() == r.ok.tolist()} "
                          f"({int(ok.sum())}/5), bad frozen {torch.equal(y[2], y0[2])}, A_end "
                          f"{normwise(y[g], r.A_end[g]):.2e}, peak {e_pk:.2e}", flush=True)


def vector(lib9):
    """K9 against its plain version, every body, fp64 and fp32."""
    vg = psa.vgnlse
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    cases = (("manakov", None), ("cnlse", None), ("isotropic", None),
             ("manakov", (0.18, 1.2e15)), ("isotropic", (0.18, None)))
    for n in (256, 384, 640):
        grid = vg.TimeGrid.for_pulse(1e-12, n_samples=n)
        A0 = vector_pulses(grid, 5)
        A0[2] *= 1e3                                  # with the loss below: overflows
        for coupling, nl_case in cases if n < 640 else cases[3:]:
            co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=2e-3, alpha_1_m=5e-5,
                                       coupling=coupling, dbeta0_1_m=8.0, dbeta1_s_m=1e-13)
            nl = None if nl_case is None else psa.gnlse.make_nl_terms(
                grid, f_raman=nl_case[0], omega0=nl_case[1])
            for rdt, cdt in ((torch.float64, torch.complex128), (torch.float32, torch.complex64)):
                gamma, alpha, b, ph = vg.lane_coeffs(co, 5, n, rdt, "cpu")
                alpha = alpha.clone()
                alpha[2] = -4e6 if rdt == torch.float64 else -4e4
                nl_t = psa.gnlse._cast_nl(nl, rdt, "cpu")
                y0 = torch.as_tensor(A0).to(cdt)
                for n_steps, rows in ((12, False), (14, True)):
                    phr = ph if not rows else (
                        ph[None] * torch.linspace(0.9, 1.1, 5, dtype=rdt)[:, None, None])
                    phr = phr.contiguous()
                    pk, y, ok = k9(lib9, y0, gamma, alpha, b, phr, co.coherent, nl_t, 0.02,
                                   n_steps, 4)
                    r = cv.solve_vgnlse_batch_torch(y0, gamma, alpha, b, phr, co.coherent,
                                                    dz_m=0.02, n_steps=n_steps, save_every=4,
                                                    nl=nl_t)
                    g = r.ok
                    e_pk = float(((pk[g] - r.peak_max[g]) / r.peak_max[g]).abs().max())
                    print(f"K9 n={n} {coupling} {'nl ' if nl_case else ''}{str(rdt)[6:]} "
                          f"{n_steps} steps {'per-instance' if rows else 'shared'} planes: ok "
                          f"{ok.tolist() == r.ok.tolist()} ({int(ok.sum())}/5), bad frozen "
                          f"{torch.equal(y[2], y0[2])}, A_end {normwise(y[g], r.A_end[g]):.2e}, "
                          f"peak {e_pk:.2e}", flush=True)


def gnlse_rk45(lib8):
    """K8's GNLSE route against its plain version, fp64 and fp32."""
    gn = psa.gnlse
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    P0 = gn.soliton_peak_power(-2e-26, 2e-3, 1e-12)
    for n in (256, 384):
        grid = gn.TimeGrid.for_pulse(1e-12, n_samples=n)
        A0 = np.sqrt(np.linspace(0.5, 1.5, 5) * P0)[:, None] / np.cosh(grid.t()[None, :] / 1e-12)
        A0[2] *= 1e12
        co = gn.make_gnlse_coeffs(grid, disp, gamma_W_m=2e-3, alpha_1_m=5e-5)
        for rdt, cdt in ((torch.float64, torch.complex128), (torch.float32, torch.complex64)):
            rtol, atol = (1e-9, 1e-12) if rdt == torch.float64 else (1e-5, 1e-9)
            gamma, alpha, ph = gn.lane_coeffs(co, 5, n, rdt, "cpu")
            y0 = torch.as_tensor(A0.astype(np.complex128)).to(cdt)
            for n_steps in (40, 43):
                pk, y, ok, na, nr = k8_gnlse(lib8, y0, gamma, alpha, ph, 0.05, n_steps, 10, rtol,
                                             atol)
                r = csa.solve_gnlse_batch_rk45_torch(y0, gamma, alpha, ph, dz_m=0.05,
                                                     n_steps=n_steps, save_every=10, rtol=rtol,
                                                     atol=atol)
                g = r.ok
                same = torch.equal(na, r.n_accepted) and torch.equal(nr, r.n_rejected)
                print(f"K8-GNLSE n={n} {str(rdt)[6:]} {n_steps} steps: ok "
                      f"{ok.tolist() == r.ok.tolist()}, counters equal {same}, A_end "
                      f"{normwise(y[g], r.A_end[g]):.2e}", flush=True)


def comb(lib4, lib5):
    """K4 against its plain version, every method, and K5 against its own,
    fp64 and fp32."""
    nw = psa.nwave
    oc = 2 * np.pi * 193.1e12
    for N in (16, 33, 64, 100):
        grid = nw.CombGrid.centered(oc, 2 * np.pi * 50e9, N)
        beta = nw.comb_beta_lin(grid, psa.DispersionParams.from_betas(oc, beta2=-1e-27,
                                                                       beta3=1.2e-41))
        A0 = np.broadcast_to(nw.seed_comb(grid, pump_lines={N // 4: 0.5, 3 * N // 4: 0.5},
                                          noise_floor_W=1e-9), (5, N)).copy()
        g = np.linspace(5e-3, 15e-3, 5)
        A0[2] *= 1e3
        g[2] = 1e3
        for rdt, cdt in ((torch.float64, torch.complex128), (torch.float32, torch.complex64)):
            t = (torch.as_tensor(A0).to(cdt),
                 *(torch.as_tensor(np.ascontiguousarray(v), dtype=rdt)
                   for v in (g, np.full(5, 5e-5), np.broadcast_to(beta, (5, N)))))
            dz = 5.0 if N <= 64 else 2.5  # AB4 is unstable at 5 m on 100 lines
            for method in ("rk4", "ab4", "abm4"):
                pk, A, ok = k4(lib4, *t, dz, 105, 10, method)
                r = cc.solve_comb_batch_torch(*t, dz_m=dz, n_steps=105, save_every=10,
                                              integrator=method)
                gd = r.ok
                print(f"K4 N={N} {method} {str(rdt)[6:]} 105 steps: ok "
                      f"{ok.tolist() == r.ok.tolist()}, bad frozen {torch.equal(A[2], t[0][2])}, "
                      f"A_end {normwise(A[gd], r.A_end[gd]):.2e}, P_max "
                      f"{normwise(pk[gd], r.P_max[gd]):.2e}", flush=True)
            rtol, atol = (1e-9, 1e-12) if rdt == torch.float64 else (1e-6, 1e-10)
            pk, A, ok, na, nr = k5(lib5, *t, 5.0, 105, 10, rtol, atol)
            with host_libm():
                r = cca.solve_comb_batch_rk45_torch(*t, dz_m=5.0, n_steps=105, save_every=10,
                                                    rtol=rtol, atol=atol)
            gd = r.ok
            same = torch.equal(na, r.n_accepted) and torch.equal(nr, r.n_rejected)
            print(f"K5 N={N} {str(rdt)[6:]} 105 steps: ok {ok.tolist() == r.ok.tolist()}, "
                  f"counters equal {same}, A_end {normwise(A[gd], r.A_end[gd]):.2e}, P_max "
                  f"{normwise(pk[gd], r.P_max[gd]):.2e}; failed comb: accepted {int(na[2])} "
                  f"(plain {int(r.n_accepted[2])}), A_end {normwise(A[2:3], r.A_end[2:3]):.2e}",
                  flush=True)
            if rdt == torch.float32:
                # both float32 solutions against the plain float64 one
                t64 = tuple(v.to(torch.complex128 if v.is_complex() else torch.float64)
                            for v in t)
                q = cca.solve_comb_batch_rk45_torch(*t64, dz_m=5.0, n_steps=105, save_every=10,
                                                    rtol=rtol, atol=atol)
                ref = q.A_end[gd].to(A.dtype)
                print(f"K5 N={N} float32 against the plain float64 version at rtol {rtol:g}: "
                      f"kernel {normwise(A[gd], ref):.2e}, plain {normwise(r.A_end[gd], ref):.2e};"
                      f" failed comb accepted {int(q.n_accepted[2])}", flush=True)


def failed_comb_norm():
    """The error norm of the 16-line failed comb's attempt at the smallest
    step of a 50 m segment (``comb``'s comb 2 at rtol 1e-6 and atol 1e-10):
    float32 with the kernels' coupling (the plain versions' default), with
    the dense-DFT and FFT couplings and with the RHS formed in float64 and
    rounded once to float32, and float64.  A norm above 1 rejects the
    step, which then fails the comb."""
    nw = psa.nwave
    oc = 2 * np.pi * 193.1e12
    grid = nw.CombGrid.centered(oc, 2 * np.pi * 50e9, 16)
    beta = nw.comb_beta_lin(grid, psa.DispersionParams.from_betas(oc, beta2=-1e-27,
                                                                   beta3=1.2e-41))
    A0 = 1e3 * nw.seed_comb(grid, pump_lines={4: 0.5, 12: 0.5}, noise_floor_W=1e-9)[None]
    h = 1e-12 * (50.0 + 1.0)
    f64 = nw.make_rhs_nwave("fft")
    v64 = [torch.tensor(v, dtype=torch.float64) for v in ([1e3], [5e-5], beta[None])]
    c64 = nw.NWaveCoeffs(*v64)
    for label, rdt, rhs in (("float32, the kernels' coupling", torch.float32, cc.plain_rhs()),
                            ("float32, dense DFT", torch.float32, nw.make_rhs_nwave("dft")),
                            ("float32, FFT", torch.float32, nw.make_rhs_nwave("fft")),
                            ("float32, RHS in float64", torch.float32,
                             lambda z, y, p: f64(z, y.to(torch.complex128), c64).to(y.dtype)),
                            ("float64, dense DFT", torch.float64, nw.make_rhs_nwave("dft"))):
        co = nw.NWaveCoeffs(*(v.to(rdt) for v in v64))
        y = torch.as_tensor(A0).to(torch.complex64 if rdt == torch.float32 else torch.complex128)
        hc = torch.tensor([[h]], dtype=rdt)
        y5, err, _ = psa.ops.adaptive._dp45(rhs, 0.0, y, rhs(0.0, y, co), hc, co)
        en = psa.ops.adaptive._error_norm(err, y, y5, atol=1e-10, rtol=1e-6, batch_ndim=1)
        print(f"K5 failed comb, N=16, attempt at dt_min = {h:.3g} m: {label}: error norm "
              f"{float(en[0]):.4g}", flush=True)


def fwm4(lib1, lib3):
    """K1/K2 (one thread a lane) and K3 (a lane over 4 threads and over one)
    against their plain versions, fp64 and fp32."""
    for rdt in (torch.float64, torch.float32):
        t = fwm4_lanes(130, rdt)
        for method in ("rk4", "ab4", "abm4"):
            rk = k1(lib1, *t, 0.2, 253, 7, method)
            rp = cs.solve_batch_torch(*t, dz_m=0.2, n_steps=253, save_every=7, integrator=method)
            print(f"K1/K2 {method} {str(rdt)[6:]}: ok {torch.equal(rk.ok, rp.ok)} "
                  f"({int(rk.ok.sum())}/130), A_end {normwise(rk.A_end, rp.A_end):.2e}, P_max "
                  f"{normwise(rk.P_max, rp.P_max):.2e}", flush=True)
        rtol, atol = (1e-10, 1e-13) if rdt == torch.float64 else (1e-6, 1e-10)
        for sms in (132, 0):
            with sm_count(lib3, sms):
                rk = k3(lib3, *t, 2.0 ** -5, 253, 7, rtol, atol)
                G = lib3.fwm4_rk45_group(130)
            with host_libm():
                rp = ca.solve_batch_rk45_torch(*t, dz_m=2.0 ** -5, n_steps=253, save_every=7,
                                               rtol=rtol, atol=atol)
            same = torch.equal(rk.n_accepted, rp.n_accepted) and torch.equal(
                rk.n_rejected, rp.n_rejected)
            print(f"K3 {str(rdt)[6:]} G={G}: ok {torch.equal(rk.ok, rp.ok)}, counters equal "
                  f"{same}, bit for bit "
                  f"{torch.equal(rk.A_end, rp.A_end) and torch.equal(rk.P_max, rp.P_max)}",
                  flush=True)


def readings():
    """The plain vector version at chip_smoke.py's configuration on 8 of its
    1,024 instances (T = 1,024, 1,000 steps of 0.01 m, save_every=100,
    theta = 0.4, alpha 5e-5): fp32 and gamma 0.1% off against fp64."""
    vg = psa.vgnlse
    grid = vg.TimeGrid.for_pulse(1e-12, n_samples=1024)
    disp = psa.DispersionParams.from_betas(1.2e15, beta2=-2e-26)
    sub = np.linspace(0, 1023, 8).astype(int)
    A0 = vector_pulses(grid, 1024)[sub]
    kw = dict(dz_m=0.01, n_steps=1000, save_every=100)
    for coupling, nl_case, bire in (("manakov", None, {}),
                                    ("cnlse", None, dict(dbeta0_1_m=0.3, dbeta1_s_m=1e-13)),
                                    ("isotropic", None, dict(dbeta0_1_m=8.0)),
                                    ("manakov", (0.18, 1.2e15), {})):
        co = vg.make_vgnlse_coeffs(grid, disp, gamma_W_m=2e-3, alpha_1_m=5e-5, coupling=coupling,
                                   **bire)
        nl = None if nl_case is None else psa.gnlse.make_nl_terms(
            grid, f_raman=nl_case[0], omega0=nl_case[1])
        out = {}
        for rdt, cdt in ((torch.float64, torch.complex128), (torch.float32, torch.complex64)):
            gamma, alpha, b, ph = vg.lane_coeffs(co, 8, 1024, rdt, "cpu")
            nl_t = psa.gnlse._cast_nl(nl, rdt, "cpu")
            y0 = torch.as_tensor(A0).to(cdt)
            out[rdt] = cv.solve_vgnlse_batch_torch(y0, gamma, alpha, b, ph, co.coherent,
                                                   nl=nl_t, **kw)
            if rdt == torch.float64:
                out["off"] = cv.solve_vgnlse_batch_torch(y0, gamma * (1 + 1e-3), alpha, b, ph,
                                                         co.coherent, nl=nl_t, **kw)
        ref = out[torch.float64]

        def err(r):
            return (normwise(r.A_end.to(torch.complex128), ref.A_end),
                    float(((r.peak_max.double() - ref.peak_max) / ref.peak_max).abs().max()))

        e32, eoff = err(out[torch.float32]), err(out["off"])
        print(f"{coupling}{' nl' if nl_case else ''}: plain fp32 vs plain fp64 A_end {e32[0]:.3e}, "
              f"peak {e32[1]:.3e}; gamma 0.1% off vs plain fp64 A_end {eoff[0]:.3e}, "
              f"peak {eoff[1]:.3e}")


def main():
    torch.set_num_threads(1)
    if "--readings" in sys.argv:
        readings()
        return
    lib6, lib7, lib8 = build("gnlse_ssfm"), build("lle_ssfm"), build("ssfm_rk45")
    scalar_nl(lib6)
    vector(build("vgnlse_ssfm"))
    for n in (256, 384, 512, 1024, 2048):
        grid = psa.lle.TimeGrid(n_samples=n, t_window_s=20.0)
        dets = np.linspace(3.5, 4.5, 5)
        co = psa.lle.make_lle_coeffs(grid, detuning=dets, pump=2.2 * np.exp(0.3j), d2=-1.0)
        seeds = np.stack([psa.lle.soliton_ansatz(grid, d, 2.2, -1.0) for d in dets])
        for rdt, cdt, bad in ((torch.float64, torch.complex128, 1e160),
                              (torch.float32, torch.complex64, 1e25)):
            for rows in (False, True):
                psi0 = seeds.copy()
                psi0[2] *= bad                   # |psi|^2 overflows the type
                det, F, ph = psa.lle.lane_coeffs(co, 5, n, rdt, "cpu")
                if rows:
                    ph = (ph[None] * torch.linspace(0.8, 1.2, 5, dtype=rdt)[:, None]).contiguous()
                y0 = torch.as_tensor(psi0).to(cdt)
                label = f"n={n} {str(rdt)[6:]} {'per-cavity' if rows else 'shared'} phase"
                for n_steps in (20, 23):
                    pk, y, ok = k7(lib7, y0, det, F, ph, 0.01, n_steps, 4)
                    r = cl.solve_lle_batch_torch(y0, det, F, ph, dt=0.01, n_steps=n_steps,
                                                 save_every=4)
                    g = r.ok
                    print(f"K7 {label} {n_steps} steps: ok "
                          f"{ok.tolist() == r.ok.tolist()}, bad cavity frozen "
                          f"{torch.equal(y[2], y0[2])}, A_end {normwise(y[g], r.A_end[g]):.2e}, "
                          f"peak "
                          f"{float(((pk[g] - r.peak_max[g]) / r.peak_max[g]).abs().max()):.2e}")
                if n != 256:
                    continue
                rtol, atol = (1e-8, 1e-11) if rdt == torch.float64 else (1e-5, 1e-8)
                for n_steps in (40, 43):
                    pk, y, ok, na, nr = k8(lib8, y0, det, F, ph, 0.01, n_steps, 10, rtol, atol)
                    r = csa.solve_lle_batch_rk45_torch(y0, det, F, ph, dt=0.01, n_steps=n_steps,
                                                       save_every=10, rtol=rtol, atol=atol)
                    g = r.ok
                    same = torch.equal(na, r.n_accepted) and torch.equal(nr, r.n_rejected)
                    print(f"K8-LLE {label} {n_steps} steps: ok "
                          f"{ok.tolist() == r.ok.tolist()}, counters equal {same}, bad cavity "
                          f"rejected {int(nr[2])} times, A_end {normwise(y[g], r.A_end[g]):.2e}")
    gnlse_rk45(lib8)
    comb(build("comb_rk"), build("comb_rk45"))
    failed_comb_norm()
    fwm4(build("fwm4_rk"), build("fwm4_rk45"))


if __name__ == "__main__":
    main()
