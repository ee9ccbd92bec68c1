// Batched fixed-step LLE cavity integration by the symmetric (Strang)
// split-step Fourier method with an affine linear substep, one CUDA thread
// block per cavity, the whole integration in one launch.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_gnlse.py::_kernel_body built with affine=True by
//   ops/pallas_lle.py   (K7, the LLE cavity)
// with one template, lle_ssfm_kernel<T, S, Narrow>, T in {double, float}:
// float64 serves x64/df32, float32 serves x32; S the samples a thread and
// Narrow the launch bounds (ssfm_common.cuh's Bounds).
//
// What it computes (the contract of models/lle.lle_fixed with method
// 'strang', which ops/cuda_lle.solve_lle_batch_torch runs, and of
// _lle_solver in the JAX package):
//   - every save chunk of k steps is Lh, (Kerr, Lf)^(k-1), Kerr, Lh, with
//     the linear substep y <- IDFT(L * DFT(y)) and L = Lh or Lf the factors
//     exp((-1 + i phi_d) s) for s = dz/2 and dz that the wrapper builds with
//     the plain version's own function (shared (n,) or one row per cavity);
//   - each linear substep ends with the affine write y <- y dp + dF, the
//     detuning rotation dp = exp(-i Delta s) and the drive offset
//     dF = F (e^{Lam0 s} - 1)/Lam0, Lam0 = -(1 + i Delta), of the cavity for
//     s = dz/2 (with Lh) or dz (with Lf), which the wrapper builds in
//     float64;
//   - Kerr is the exact rotation y exp(i (1 |y|^2) dz) (gamma = 1);
//   - ok starts as "y0 is finite"; after each chunk a non-finite state
//     clears ok and the cavity keeps its last good state (which it then
//     keeps for good: the rest of the run cannot change its outputs, so the
//     block stops); otherwise the state is saved and the peak, the running
//     max over saved samples of max_t |y|^2 (from y0, NaN propagating),
//     grows; the trailing n_steps % save_every steps are integrated from the
//     last saved state and feed only ok.
//
// What bounds it: the latency of the transform passes, not their arithmetic
// (at the LLE width, n = 256, a Strang step is one transform pair of about
// 10 n log2 n flop and O(n) pointwise work, one cavity a block of 2 warps).
// So the design cuts the passes and barriers, as K8's LLE route does
// (csrc/ssfm_rk45.cu):
//   - the transforms are ssfm_common.cuh's slot_fft: radix-4 Stockham passes
//     (one radix-2 pass first when log2 m is odd, the r-odd tail), a
//     float64 table and every butterfly in double, one barrier a pass; at
//     n = 256 that is 4 passes a transform, not 8;
//   - the pointwise work is folded into the last pass of each transform,
//     whose outputs the same thread owns in every transform: the factor
//     product Lh F or Lf F in the forward transform's, the 1/n, the affine
//     write and the next substep's Kerr rotation in the inverse one's.  So
//     each thread keeps its samples' Lh and Lf in registers, loaded once a
//     cavity, and the state never sits in shared memory between pointwise
//     passes: a Strang step at n = 256 is 8 barriers (about 19 with the
//     radix-2 passes and the separate factor, affine and Kerr passes);
//   - the chunk's last inverse transform forms each thread's finite flag and
//     peak, and one fused reduction (a shuffle tree in each warp, the warps'
//     maxima in warp order, the flag ANDed at its one barrier) replaces the
//     block-wide finite check and peak.
// The state and its transform partner are the only shared buffers: at
// n = 2,048 in fp64 a block takes 65,792 bytes.  The twiddles and the
// factors are read from device memory through the cache, once.
//
// Global layout (row-major, one row per cavity, complex as (re, im)):
//   y0 (B, n); lh, lf (n,) with fac_stride 0 or (B, n) with fac_stride n;
//   aff (B, 4) complex = (dp_h, dF_h, dp_f, dF_f); tw (n,) = (cos, sin)(2 pi
//   k / n) in float64; outputs peak (B,), y_last (B, n), ok (B,) uint8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" functions at the end; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssfm_common.cuh"

namespace {

using ssfm::Block;
using ssfm::Cx;

constexpr int kBuffers = 2;
constexpr int kReduceSlots = 32;

// One cavity's integration.  Slot s of a thread is sample
// ssfm::slot_sample(f, s) in every transform's last pass.
template <typename T, int S>
struct Cavity {
    Block<T> c;      // the block's view: the checks of y0, the reduction slots
    ssfm::Plan f;    // the n-point transform
    Cx<T>*y, *x;     // the state and its transform partner
    T h;
    Cx<T> dp_h, dF_h, dp_f, dF_f;
    Cx<T> lh[S], lf[S];  // the factors of the thread's samples

    // One transform of in through the pair (in is one of them); returns the
    // buffer the last pass's Post wrote.  No barrier after the last pass.
    template <bool INV, class Post>
    __device__ __forceinline__ Cx<T>* xf(const Cx<T>* in, const Post& post) {
        Cx<T>* s0 = in == y ? x : y;
        return ssfm::slot_fft<T, INV, S, false>(f, in, s0, s0 == y ? x : y, post);
    }

    // One linear substep, y <- IDFT(L DFT(y)) dp + dF with the factors of dz
    // (full) or dz/2, then, with kerr, the next substep's Kerr rotation.
    // Without kerr (a chunk's last substep) it returns whether the new state
    // is finite, in every thread, and leaves its peak in pk.
    __device__ __forceinline__ bool lin(bool full, bool kerr, T& pk) {
        const Cx<T> dp = full ? dp_f : dp_h, dF = full ? dF_f : dF_h;
        Cx<T>* u = xf<false>(y, [&](int s, int k, const Cx<double>& v, Cx<T>* o) {
            const Cx<double> p = ssfm::times(full ? lf[s] : lh[s], v);
            o[k] = Cx<T>{T(p.re), T(p.im)};
        });
        __syncthreads();
        int fin = 1;
        T peak = T(0);
        u = xf<true>(u, [&](int, int k, const Cx<double>& v, Cx<T>* o) {
            Cx<T> a = ssfm::affine_of(Cx<T>{T(v.re * c.inv_n), T(v.im * c.inv_n)}, dp, dF);
            if (kerr) {
                a = ssfm::kerr_of(a, T(1), h);
            } else {
                fin &= (isfinite(a.re) && isfinite(a.im)) ? 1 : 0;
                peak = ssfm::nan_max(peak, a.re * a.re + a.im * a.im);
            }
            o[k] = a;
        });
        if (u != y) {
            x = y;
            y = u;
        }
        if (kerr) {
            __syncthreads();
            return true;
        }
        // the fused reduction: a shuffle tree in each warp, the warps'
        // maxima in warp order, one barrier (which also ANDs the flag)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            peak = ssfm::nan_max(peak, __shfl_down_sync(0xffffffffu, peak, o));
        if ((c.tid & 31) == 0) c.red[c.tid >> 5] = peak;
        const bool finite = __syncthreads_and(fin) != 0;
        pk = c.red[0];
        for (int w = 1; w < (c.nt >> 5); ++w) pk = ssfm::nan_max(pk, c.red[w]);
        return finite;
    }

    // k fused symmetric steps: Lh, (Kerr, Lf)^(k-1), Kerr, Lh; whether the
    // state is finite, and its peak in pk.
    __device__ __forceinline__ bool steps(int kk, T& pk) {
        lin(false, true, pk);
        for (int i = 1; i < kk; ++i) lin(true, true, pk);
        return lin(false, false, pk);
    }
};

template <typename T, int S, bool Narrow>
__global__ void __launch_bounds__(ssfm::Bounds<S, Narrow>::kThreads,
                                  ssfm::Bounds<S, Narrow>::kBlocks)
lle_ssfm_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                const Cx<T>* __restrict__ lf, int fac_stride, const Cx<T>* __restrict__ aff,
                const Cx<double>* __restrict__ tw, T* __restrict__ pk_out,
                Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out, int n, int n_steps,
                int save_every, double dz) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    Cavity<T, S> st;
    Block<T>& c = st.c;
    c.tw = tw;
    c.red = reinterpret_cast<T*>(smem);
    c.n = n;
    ssfm::split(n, &c.m, &c.r);
    c.tid = threadIdx.x;
    c.nt = blockDim.x;
    c.inv_n = 1.0 / n;
    st.f = ssfm::plan(tw, n, 1, c.tid, c.nt);
    Cx<T>* buf = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
    st.y = buf;
    st.x = buf + n;
    st.h = T(dz);
    const Cx<T>* a = aff + 4 * static_cast<size_t>(b);
    st.dp_h = a[0];
    st.dF_h = a[1];
    st.dp_f = a[2];
    st.dF_f = a[3];
    const Cx<T>* Lh = lh + static_cast<size_t>(b) * fac_stride;
    const Cx<T>* Lf = lf + static_cast<size_t>(b) * fac_stride;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const bool in = ssfm::slot_valid<S>(st.f, s);
        const int k = ssfm::slot_sample(st.f, s);
        st.lh[s] = in ? Lh[k] : Cx<T>{T(0), T(0)};
        st.lf[s] = in ? Lf[k] : Cx<T>{T(0), T(0)};
    }

    Cx<T>* out = y_last + static_cast<size_t>(b) * n;
    for (int j = c.tid; j < n; j += c.nt) {
        const Cx<T> v = y0[static_cast<size_t>(b) * n + j];
        st.y[j] = v;
        out[j] = v;
    }
    bool ok = ssfm::block_finite(c, st.y);
    T pk = ssfm::block_peak(c, st.y);
    const int n_chunks = n_steps / save_every, rem = n_steps - n_chunks * save_every;
    if (ok) {
        for (int i = 0; i < n_chunks; ++i) {
            T p;
            if (!st.steps(save_every, p)) {
                ok = false;  // y_last keeps the last good state
                break;
            }
            // the thread's own samples of the new state
#pragma unroll
            for (int s = 0; s < S; ++s) {
                if (ssfm::slot_valid<S>(st.f, s)) {
                    const int k = ssfm::slot_sample(st.f, s);
                    out[k] = st.y[k];
                }
            }
            pk = ssfm::nan_max(pk, p);
        }
        if (ok && rem > 0) {
            T p;
            ok = st.steps(rem, p);
        }
    }
    if (c.tid == 0) {
        pk_out[b] = pk;
        ok_out[b] = ok ? 1 : 0;
    }
}

size_t shared_bytes(int n, size_t elem) {
    return elem * (kReduceSlots + 2 * static_cast<size_t>(kBuffers) * n);
}

template <typename T, int S, bool Narrow>
int launch_slots(int threads, const void* y0, const void* lh, const void* lf, int fac_stride,
                 const void* aff, const void* tw, void* pk, void* y_last, void* ok, int B, int n,
                 int n_steps, int save_every, double dz, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(lle_ssfm_kernel<T, S, Narrow>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lle_ssfm_kernel<T, S, Narrow><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Cx<T>*>(y0), static_cast<const Cx<T>*>(lh),
        static_cast<const Cx<T>*>(lf), fac_stride, static_cast<const Cx<T>*>(aff),
        static_cast<const Cx<double>*>(tw), static_cast<T*>(pk), static_cast<Cx<T>*>(y_last),
        static_cast<uint8_t*>(ok), n, n_steps, save_every, dz);
    return static_cast<int>(cudaGetLastError());
}

// The width's block: S = ssfm::default_slots(n), ssfm::block_threads(n, S)
// threads, Narrow when it has at most 128.
template <typename T>
int launch(const void* y0, const void* lh, const void* lf, int fac_stride, const void* aff,
           const void* tw, void* pk, void* y_last, void* ok, int B, int n, int n_steps,
           int save_every, double dz, void* stream) {
    const int S = ssfm::default_slots(n);
    const int threads = ssfm::block_threads(n, S);
    if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
#define LLE_SSFM_ARGS \
    threads, y0, lh, lf, fac_stride, aff, tw, pk, y_last, ok, B, n, n_steps, save_every, dz, stream
    if (S == 8) return launch_slots<T, 8, false>(LLE_SSFM_ARGS);
    if (threads <= ssfm::Bounds<4, true>::kThreads) return launch_slots<T, 4, true>(LLE_SSFM_ARGS);
    return launch_slots<T, 4, false>(LLE_SSFM_ARGS);
#undef LLE_SSFM_ARGS
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" int lle_ssfm_shared_bytes(int n, int elem) {
    return static_cast<int>(shared_bytes(n, static_cast<size_t>(elem)));
}

#define LLE_SSFM_LAUNCHER(NAME, T)                                                             \
    extern "C" int NAME(const void* y0, const void* lh, const void* lf, int fac_stride,        \
                        const void* aff, const void* tw, void* pk, void* y_last, void* ok,     \
                        int B, int n, int n_steps, int save_every, double dt, void* stream) {  \
        return launch<T>(y0, lh, lf, fac_stride, aff, tw, pk, y_last, ok, B, n, n_steps,      \
                         save_every, dt, stream);                                              \
    }

LLE_SSFM_LAUNCHER(lle_ssfm_f64, double)
LLE_SSFM_LAUNCHER(lle_ssfm_f32, float)
