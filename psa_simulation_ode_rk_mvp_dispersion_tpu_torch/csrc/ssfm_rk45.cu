// Batched adaptive split-step Fourier integration by step doubling (the
// "local error method", Sinkin et al., J. Lightwave Technol. 21, 2003): the
// GNLSE with Kerr nonlinearity and flat loss, or the LLE cavity; one CUDA
// thread block per envelope, every save segment and the trailing span in
// one launch.
//
// Replaces both routes of the JAX package's TPU kernel
//   ops/pallas_ssfm_adaptive.py::_kernel_body   (K8)
// with one template, ssfm_rk45_kernel<T, Affine, S, Narrow>, T in {double,
// float}: float64 serves x64, float32 serves x32; Affine false is the GNLSE
// route, true the LLE route; S the samples a thread and Narrow the launch
// bounds (below).
//
// What it computes (the contract of models/gnlse.gnlse_adaptive with method
// 'strang' and no nonlinear terms, which
// ops/cuda_ssfm_adaptive.solve_gnlse_batch_rk45_torch runs, and of
// _gnlse_adaptive_solver(reduce_mode=True) in the JAX package):
//   - each attempt of size h (models/gnlse._doubling_attempt): the factor
//     Lq = exp((-alpha/2 + i phi) h/4) built here from the phase rate and
//     -alpha/2, Lc = Lq^2 = exp(L h/2); one shared DFT of y; the coarse step
//     yc = IDFT(Lc DFT(K_h(IDFT(Lc DFT y)))) and the two fused fine steps
//     yf = IDFT(Lq DFT(K_{h/2}(IDFT(Lc DFT(K_{h/2}(IDFT(Lq DFT y))))))), with
//     K_s the exact Kerr rotation: 9 transforms;
//   - the error norm sqrt(mean |yf - yc|^2) / max(atol + rtol sqrt(max(mean
//     |yf|^2, mean |y|^2)), tiny), each mean one block reduction in a fixed
//     order; the candidate state (4 yf - yc)/3;
//   - accept when the norm and both states are finite, the norm <= 1, and
//     the candidate's mean power is at most 1e30 (above it the envelope
//     fails at once: a linear blowup has no split error to control); the
//     factor clip(0.9 max(norm, 1e-16)^(-1/3), 0.2, 5), or 0.5 for a
//     non-finite attempt; an accepted step clipped by the segment's end
//     keeps dt, any other sets dt = max(h factor, dt_min);
//   - segments [i seg, (i+1) seg] in absolute z, h = min(dt, z_end - z),
//     dt_min = 1e-12 (segment length + 1), dt from dt0 = dz carried across
//     segments, at most max_steps attempts of this envelope a segment; a
//     rejection at dt_min fails the envelope, and so does a segment it does
//     not finish; a failed envelope keeps its last accepted state;
//   - the peak over the saved states (from y0, NaN propagating); y_last the
//     state at the last grid point; the trailing span [n_chunks seg, z_end]
//     feeds only ok and the counters.
// The LLE route (Affine; models/lle.lle_adaptive with method 'strang',
// which ops/cuda_ssfm_adaptive.solve_lle_batch_rk45_torch runs, and
// _lle_adaptive_solver of the JAX package) is the same attempt with alpha =
// 2 and gamma = 1, and after each of the five inverse transforms the affine
// write y <- y dp + dF: dp_q = exp(-i Delta h/4), dp_h = dp_q^2 (squared,
// as the JAX scan forms it), dF_s = F (e^{Lam0 s} - 1)/Lam0 with
// Lam0 = -(1 + i Delta) for s = h/4 and h/2, each computed directly; the
// coarse step takes (Lc, dp_h, dF_h) for both of its linear maps, the fine
// pair (Lq, dp_q, dF_q), (Lc, dp_h, dF_h), (Lq, dp_q, dF_q).
// The JAX kernel's no-shrink-on-accept deadband (a guard against its bf16
// transform noise) is not copied: this is the scan's controller.
//
// What bounds it: latency, not arithmetic (on an H100 an attempt at the LLE
// width takes about as long in fp32 as in fp64, 17 and 19 us).  An attempt
// is 9 transforms of about 5 n log2 n flop each and O(n) pointwise work on a
// state of n samples, one envelope a block, a chain of passes each ending at
// a barrier, and at the LLE width (n = 256) a block has only 2 warps to hide
// each pass's latency.  So the design cuts the passes and barriers:
//   - the transforms are ssfm_common.cuh's slot_fft: wide_fft's radix-4
//     Stockham passes (one radix-2 pass first when log2 m is odd, the
//     r-odd tail), float64 twiddles and double butterflies, one barrier a
//     pass; at n = 256 that is 4 passes a transform, not 8;
//   - the pointwise work is folded into the last pass of each transform,
//     whose outputs the same thread owns in every transform: the factor
//     products Lc F and Lq F in the forward transforms', the 1/n, the LLE
//     affine write and the Kerr rotation in the inverse ones'.  So the
//     factors Lq of a thread's samples are registers, formed once an
//     attempt (Lc = Lq^2 is formed where it is used), and the coarse state
//     yc stays in registers from the coarse step's last pass to the error
//     sums;
//   - the error sums (|yf - yc|^2, |yf|^2, |y|^2), the finite flag and the
//     candidate's power come out of the fine step's last pass and go
//     through one fused reduction: for each value a shuffle tree in each
//     warp, then the warps' sums in warp order, the flag ANDed at the one
//     barrier.
// At n = 256 an attempt has 36 barriers: 9 transforms of 4 passes, the
// last pass's barrier of the fine step being the reduction's.
// The samples a thread (S) is a template constant: 4 up to n = 1,024 (64
// threads a cavity at the LLE width, 256 at n = 1,024), 8 above.  At the
// LLE width 64 threads a cavity beat 128 and 32 on an H100 (PERF.md).
// A block of at most 128 threads (Narrow) leaves a thread every register
// it asks for: at the LLE width 512 cavities are about 4 blocks of 64
// threads an SM, which 255 registers a thread allow; a wider block asks for
// two blocks an SM (128 registers) at 4 samples a thread, one at 8.  The
// state and three buffers live in shared memory (the transform pair and the
// fine spectrum; the candidate lands in the pair and becomes the state by a
// pointer swap): at n = 2,048 in fp64 131,328 bytes.  The twiddles and the
// phase rate are read through the read-only cache.
//
// Global layout (row-major, one row per envelope, complex as (re, im)):
//   y0 (B, n); gamma, alpha (B,) (GNLSE) or det (B,) and pump (B,) complex
//   (LLE); ph (n,) with ph_stride 0 or (B, n) with ph_stride n; tw (n,) =
//   (cos, sin)(2 pi k / n) in float64; outputs peak (B,), y_last (B, n), ok
//   (B,) uint8, n_accepted, n_rejected (B,) int32.
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

constexpr int kBuffers = 4;
constexpr int kReduceSlots = 32;
constexpr int kSums = 4;  // |yf - yc|^2, |yf|^2, |y|^2, |candidate|^2

// a / b by the scaled (Smith) division of torch's complex type.
template <typename T>
__device__ Cx<T> cdiv(const Cx<T>& a, const Cx<T>& b) {
    if (fabs(b.re) >= fabs(b.im)) {
        const T rat = b.im / b.re, scl = T(1) / (b.re + b.im * rat);
        return Cx<T>{(a.re + a.im * rat) * scl, (a.im - a.re * rat) * scl};
    }
    const T rat = b.re / b.im, scl = T(1) / (b.im + b.re * rat);
    return Cx<T>{(a.re * rat + a.im) * scl, (a.im * rat - a.re) * scl};
}

// One envelope's adaptive integration.  Slot s of a thread is sample
// ssfm::slot_sample(f, s) in every transform's last pass.
template <typename T, bool Affine, int S>
struct Doubling {
    static constexpr int kSlots = S;
    Block<T> c;        // the block's view for the finite check and the peak
    ssfm::Plan f;      // the n-point transform
    Cx<T>* y;          // the state
    Cx<T>*fa, *fb;     // the transform pair
    Cx<T>* fc;         // the fine spectrum Lq DFT(y)
    const T* ph;       // (n,) phase rate of this envelope
    T g, nha, rtol, atol;
    T det;             // Affine: the detuning and the pump of this cavity
    Cx<T> F;
    T dt;
    bool ok;
    int n_acc, n_rej;
    Cx<T> lq[kSlots], yc[kSlots];  // exp(L h/4), the coarse state

    // exp(L h/2) = exp(L h/4)^2 of slot s, formed where it is used.
    __device__ __forceinline__ Cx<T> lc(int s) const {
        const Cx<T> q = lq[s];
        return Cx<T>{q.re * q.re - q.im * q.im, q.re * q.im + q.im * q.re};
    }

    // w v in double, rounded once.
    static __device__ __forceinline__ Cx<T> times(const Cx<T>& w, const Cx<double>& v) {
        const Cx<double> p = ssfm::times(w, v);
        return Cx<T>{T(p.re), T(p.im)};
    }

    // An inverse transform's output: v / n in double, rounded, then,
    // Affine, y dp + dF.
    __device__ __forceinline__ Cx<T> lin_out(const Cx<double>& v, const Cx<T>& dp,
                                             const Cx<T>& dF) const {
        const Cx<T> x{T(v.re * c.inv_n), T(v.im * c.inv_n)};
        if constexpr (Affine) return ssfm::affine_of(x, dp, dF);
        return x;
    }

    __device__ __forceinline__ Cx<T> kerr(const Cx<T>& x, T s) const {
        return ssfm::kerr_of(x, g, s);
    }

    // One transform of in through the pair (in may be one of them).
    template <bool INV, bool Sync = true, class Post>
    __device__ __forceinline__ Cx<T>* xf(const Cx<T>* in, const Post& post) {
        Cx<T>* s0 = in == fa ? fb : fa;
        return ssfm::slot_fft<T, INV, S, Sync>(f, in, s0, s0 == fa ? fb : fa, post);
    }

    // The drive offset F (e^{Lam0 s} - 1)/Lam0, Lam0 = -(1 + i det), in the
    // plain version's order (models/lle._drive_offset).
    __device__ __forceinline__ Cx<T> drive(T s) const {
        T sn, cs;
        ssfm::sin_cos(-det * s, &sn, &cs);
        const T e = exp(-s);
        const Cx<T> m{e * cs - T(1), e * sn};
        return cdiv(Cx<T>{F.re * m.re - F.im * m.im, F.re * m.im + F.im * m.re},
                    Cx<T>{T(-1), -det});
    }

    // Advance over [za, zb].
    __device__ __forceinline__ void advance(T za, T zb, int max_steps) {
        const int n = c.n;
        const T span = (zb - za) + T(1);
        const T dt_min = T(1e-12) * span;
        T z = za;
        for (int it = 0; it < max_steps && ok && z < zb; ++it) {
            const bool clipped = (zb - z) < dt;
            const T h = fmin(dt, zb - z);
            const T h4 = T(0.25) * h, hh = T(0.5) * h;
            Cx<T> dp_q{}, dp_h{}, dF_q{}, dF_h{};
            if constexpr (Affine) {
                T sn, cs;
                ssfm::sin_cos(-det * h4, &sn, &cs);
                dp_q = Cx<T>{cs, sn};
                dp_h = Cx<T>{cs * cs - sn * sn, cs * sn + sn * cs};
                dF_q = drive(h4);
                dF_h = drive(hh);
            }
            const T decay = exp(nha * h4);
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
                if (ssfm::slot_valid<S>(f, s)) {
                    T sn, co;
                    ssfm::sin_cos(ph[ssfm::slot_sample(f, s)] * h4, &sn, &co);
                    lq[s] = Cx<T>{decay * co, decay * sn};
                }
            }
            // the shared forward transform: Lc F for the coarse step, Lq F
            // into fc for the fine pair
            Cx<T>* const fq = fc;
            Cx<T>* u = xf<false>(y, [&](int s, int k, const Cx<double>& v, Cx<T>* o) {
                o[k] = times(lc(s), v);
                fq[k] = times(lq[s], v);
            });
            // coarse: yc = lin(Lc, K_h(IDFT(Lc F))), into registers
            u = xf<true>(u, [&](int, int k, const Cx<double>& v, Cx<T>* o) {
                o[k] = kerr(lin_out(v, dp_h, dF_h), h);
            });
            u = xf<false>(u, [&](int s, int k, const Cx<double>& v, Cx<T>* o) {
                o[k] = times(lc(s), v);
            });
            xf<true>(u, [&](int s, int, const Cx<double>& v, Cx<T>*) {
                yc[s] = lin_out(v, dp_h, dF_h);
            });
            // fine: yf = lin(Lq, K_{h/2}(lin(Lc, K_{h/2}(IDFT(Lq F)))))
            u = xf<true>(fc, [&](int, int k, const Cx<double>& v, Cx<T>* o) {
                o[k] = kerr(lin_out(v, dp_q, dF_q), hh);
            });
            u = xf<false>(u, [&](int s, int k, const Cx<double>& v, Cx<T>* o) {
                o[k] = times(lc(s), v);
            });
            u = xf<true>(u, [&](int, int k, const Cx<double>& v, Cx<T>* o) {
                o[k] = kerr(lin_out(v, dp_h, dF_h), hh);
            });
            u = xf<false>(u, [&](int s, int k, const Cx<double>& v, Cx<T>* o) {
                o[k] = times(lq[s], v);
            });
            // yf, its sums against yc and y, and the candidate (4 yf - yc)/3
            // in place of yf
            T sum[kSums] = {T(0), T(0), T(0), T(0)};
            int fin = 1;
            Cx<T>* cand = xf<true, false>(u, [&](int s, int k, const Cx<double>& v, Cx<T>* o) {
                const Cx<T> a = lin_out(v, dp_q, dF_q), b = yc[s], p = y[k];
                const T dr = a.re - b.re, di = a.im - b.im;
                sum[0] += dr * dr + di * di;
                sum[1] += a.re * a.re + a.im * a.im;
                sum[2] += p.re * p.re + p.im * p.im;
                fin &= (isfinite(a.re) && isfinite(a.im) && isfinite(b.re) && isfinite(b.im))
                           ? 1 : 0;
                const Cx<T> yn{(T(4) * a.re - b.re) / T(3), (T(4) * a.im - b.im) / T(3)};
                o[k] = yn;
                sum[3] += yn.re * yn.re + yn.im * yn.im;
            });
            // the fused reduction: a shuffle tree in each warp, the warps'
            // sums in warp order, one barrier (which also ANDs the flag)
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
                for (int q = 0; q < kSums; ++q)
                    sum[q] += __shfl_down_sync(0xffffffffu, sum[q], o);
            }
            const int nw = c.nt >> 5;
            if ((c.tid & 31) == 0) {
#pragma unroll
                for (int q = 0; q < kSums; ++q) c.red[q * 8 + (c.tid >> 5)] = sum[q];
            }
            const bool states_finite = __syncthreads_and(fin) != 0;
#pragma unroll
            for (int q = 0; q < kSums; ++q) {
                T t = c.red[q * 8];
                for (int w = 1; w < nw; ++w) t += c.red[q * 8 + w];
                sum[q] = t;
            }
            const T d = sqrt(sum[0] / T(n));
            const T mf = sum[1] / T(n);
            const T my = sum[2] / T(n);
            const T sc = sqrt(ssfm::nan_max(mf, my));
            T denom = atol + rtol * sc;
            const T tiny = sizeof(T) == 8 ? T(2.2250738585072014e-308) : T(1.17549435e-38f);
            denom = denom < tiny ? tiny : denom;
            const T enorm = d / denom;
            const bool escape = sum[3] / T(n) > T(1e30);
            const bool finite = states_finite && isfinite(enorm);
            const bool accept = finite && enorm <= T(1) && !escape;
            T factor = T(0.5);
            if (finite) {
                factor = T(0.9) * pow(fmax(enorm, T(1e-16)), T(-1.0 / 3.0));
                factor = fmin(fmax(factor, T(0.2)), T(5));
            }
            const T base = (clipped && accept) ? dt : h * factor;
            dt = fmax(base, dt_min);
            if ((!accept && h <= dt_min) || escape) ok = false;
            if (accept) {
                z = z + h;
                if (cand == fa)
                    fa = y;
                else
                    fb = y;
                y = cand;
                ++n_acc;
            } else {
                ++n_rej;
            }
        }
        if (!(z >= zb)) ok = false;
    }
};

template <typename T, bool Affine, int S, bool Narrow>
__global__ void __launch_bounds__(ssfm::Bounds<S, Narrow>::kThreads,
                                  ssfm::Bounds<S, Narrow>::kBlocks)
ssfm_rk45_kernel(const Cx<T>* __restrict__ y0, const T* __restrict__ gamma,
                 const T* __restrict__ alpha, const T* __restrict__ det,
                 const Cx<T>* __restrict__ pump, const T* __restrict__ ph, int ph_stride,
                 const Cx<double>* __restrict__ tw, T* __restrict__ pk_out,
                 Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out,
                 int32_t* __restrict__ n_acc_out, int32_t* __restrict__ n_rej_out, int n,
                 int n_chunks, double seg, double z_end, int has_tail, double dt0, double rtol,
                 double atol, int max_steps) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    Doubling<T, Affine, S> s;
    s.c.tw = tw;
    s.c.red = reinterpret_cast<T*>(smem);
    s.c.n = n;
    ssfm::split(n, &s.c.m, &s.c.r);
    s.c.tid = threadIdx.x;
    s.c.nt = blockDim.x;
    s.c.inv_n = 1.0 / n;
    s.f = ssfm::plan(tw, n, 1, s.c.tid, s.c.nt);
    Cx<T>* buf = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
    s.y = buf;
    s.fa = buf + n;
    s.fb = buf + 2 * n;
    s.fc = buf + 3 * n;
    s.ph = ph + static_cast<size_t>(b) * ph_stride;
    if constexpr (Affine) {
        s.g = T(1);
        s.nha = T(-1);
        s.det = det[b];
        s.F = pump[b];
    } else {
        s.g = gamma[b];
        s.nha = T(-0.5) * alpha[b];
    }
    s.rtol = T(rtol);
    s.atol = T(atol);
    s.dt = T(dt0);
    s.n_acc = 0;
    s.n_rej = 0;
    const Block<T>& c = s.c;

    for (int j = c.tid; j < n; j += c.nt) s.y[j] = y0[static_cast<size_t>(b) * n + j];
    s.ok = ssfm::block_finite(c, s.y);
    T pk = ssfm::block_peak(c, s.y);
    for (int i = 0; i < n_chunks; ++i) {
        s.advance(T(static_cast<double>(i) * seg), T(static_cast<double>(i + 1) * seg),
                  max_steps);
        pk = ssfm::nan_max(pk, ssfm::block_peak(c, s.y));
    }
    Cx<T>* out = y_last + static_cast<size_t>(b) * n;
    for (int j = c.tid; j < n; j += c.nt) out[j] = s.y[j];
    if (has_tail) s.advance(T(static_cast<double>(n_chunks) * seg), T(z_end), max_steps);
    if (c.tid == 0) {
        pk_out[b] = pk;
        ok_out[b] = s.ok ? 1 : 0;
        n_acc_out[b] = s.n_acc;
        n_rej_out[b] = s.n_rej;
    }
}

size_t shared_bytes(int n, size_t elem) {
    return elem * (kReduceSlots + 2 * static_cast<size_t>(kBuffers) * n);
}

template <typename T, bool Affine, int S, bool Narrow>
int launch_slots(int threads, const void* y0, const void* gamma, const void* alpha,
                 const void* det, const void* pump, const void* ph, int ph_stride,
                 const void* tw, void* pk, void* y_last, void* ok, void* n_acc, void* n_rej,
                 int B, int n, int n_chunks, double seg, double z_end, int has_tail, double dt0,
                 double rtol, double atol, int max_steps, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(ssfm_rk45_kernel<T, Affine, S, Narrow>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssfm_rk45_kernel<T, Affine, S, Narrow>
        <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Cx<T>*>(y0), static_cast<const T*>(gamma),
        static_cast<const T*>(alpha), static_cast<const T*>(det),
        static_cast<const Cx<T>*>(pump), static_cast<const T*>(ph), ph_stride,
        static_cast<const Cx<double>*>(tw), static_cast<T*>(pk), static_cast<Cx<T>*>(y_last),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(n_acc), static_cast<int32_t*>(n_rej),
        n, n_chunks, seg, z_end, has_tail, dt0, rtol, atol, max_steps);
    return static_cast<int>(cudaGetLastError());
}

// The width's block: S = ssfm::default_slots(n), Narrow when it has at most
// 128 threads.
template <typename T, bool Affine>
int launch(const void* y0, const void* gamma, const void* alpha, const void* det,
           const void* pump, const void* ph, int ph_stride, const void* tw, void* pk,
           void* y_last, void* ok, void* n_acc, void* n_rej, int B, int n, int n_chunks,
           double seg, double z_end, int has_tail, double dt0, double rtol, double atol,
           int max_steps, void* stream) {
    const int S = ssfm::default_slots(n);
    const int threads = ssfm::block_threads(n, S);
    if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
#define SSFM_RK45_ARGS                                                                          \
    threads, y0, gamma, alpha, det, pump, ph, ph_stride, tw, pk, y_last, ok, n_acc, n_rej, B, n, \
        n_chunks, seg, z_end, has_tail, dt0, rtol, atol, max_steps, stream
    if (S == 8) return launch_slots<T, Affine, 8, false>(SSFM_RK45_ARGS);
    if (threads <= ssfm::Bounds<4, true>::kThreads)
        return launch_slots<T, Affine, 4, true>(SSFM_RK45_ARGS);
    return launch_slots<T, Affine, 4, false>(SSFM_RK45_ARGS);
#undef SSFM_RK45_ARGS
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" int ssfm_rk45_shared_bytes(int n, int elem) {
    return static_cast<int>(shared_bytes(n, static_cast<size_t>(elem)));
}

#define SSFM_RK45_LAUNCHER(NAME, T)                                                              \
    extern "C" int NAME(const void* y0, const void* gamma, const void* alpha, const void* ph,    \
                        int ph_stride, const void* tw, void* pk, void* y_last, void* ok,         \
                        void* n_acc, void* n_rej, int B, int n, int n_chunks, double seg,        \
                        double z_end, int has_tail, double dt0, double rtol, double atol,        \
                        int max_steps, void* stream) {                                           \
        return launch<T, false>(y0, gamma, alpha, nullptr, nullptr, ph, ph_stride, tw, pk,      \
                                y_last, ok, n_acc, n_rej, B, n, n_chunks, seg, z_end, has_tail, \
                                dt0, rtol, atol, max_steps, stream);                            \
    }

SSFM_RK45_LAUNCHER(ssfm_rk45_f64, double)
SSFM_RK45_LAUNCHER(ssfm_rk45_f32, float)

// The LLE route: det (B,) and pump (B,) complex in place of gamma and alpha.
#define SSFM_RK45_LLE_LAUNCHER(NAME, T)                                                          \
    extern "C" int NAME(const void* y0, const void* det, const void* pump, const void* ph,       \
                        int ph_stride, const void* tw, void* pk, void* y_last, void* ok,         \
                        void* n_acc, void* n_rej, int B, int n, int n_chunks, double seg,        \
                        double z_end, int has_tail, double dt0, double rtol, double atol,        \
                        int max_steps, void* stream) {                                           \
        return launch<T, true>(y0, nullptr, nullptr, det, pump, ph, ph_stride, tw, pk, y_last,  \
                               ok, n_acc, n_rej, B, n, n_chunks, seg, z_end, has_tail, dt0,     \
                               rtol, atol, max_steps, stream);                                  \
    }

SSFM_RK45_LLE_LAUNCHER(ssfm_rk45_lle_f64, double)
SSFM_RK45_LLE_LAUNCHER(ssfm_rk45_lle_f32, float)
