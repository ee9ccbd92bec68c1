// Batched adaptive split-step Fourier integration by step doubling (the
// "local error method", Sinkin et al., J. Lightwave Technol. 21, 2003): the
// GNLSE with Kerr nonlinearity and flat loss, or the LLE cavity; one CUDA
// thread block per envelope, every save segment and the trailing span in
// one launch.
//
// Replaces both routes of the JAX package's TPU kernel
//   ops/pallas_ssfm_adaptive.py::_kernel_body   (K8)
// with one template, ssfm_rk45_kernel<T, Affine>, T in {double, float}:
// float64 serves x64, float32 serves x32; Affine false is the GNLSE route,
// true the LLE route.
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
// What bounds it: arithmetic, 9 transforms of about 5 n log2 n flop each and
// O(n) pointwise work (2 n sincos for the factor, 5 affine passes for the
// LLE) an attempt, on a state of n samples.  The state, the three attempt
// buffers and the two factors live in shared memory (6 buffers; at n = 2048
// in fp64, 196,864 bytes); the twiddles and the phase rate are read through
// the read-only cache.
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
using ssfm::dft;

constexpr int kBuffers = 6;
constexpr int kReduceSlots = 32;

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

template <typename T, bool Affine>
struct Doubling {
    Block<T> c;
    Cx<T>* y;        // the state
    Cx<T>* w[3];     // attempt buffers
    Cx<T>*lq, *lc;   // exp(L h/4), exp(L h/2)
    const T* ph;     // (n,) phase rate of this envelope
    T g, nha, rtol, atol;
    T det;           // Affine: the detuning and the pump of this cavity
    Cx<T> F;
    T dt;
    bool ok;
    int n_acc, n_rej;

    // y <- IDFT(L DFT(y)) on a and the scratch b, then, Affine, y dp + dF;
    // returns where it landed.
    __device__ Cx<T>* lin(Cx<T>* a, Cx<T>* b, const Cx<T>* L, const Cx<T>& dp,
                          const Cx<T>& dF) {
        Cx<T>* f = dft<T, false>(c, a, b);
        ssfm::mul_factor(c, f, L);
        return inv(f, f == a ? b : a, dp, dF);
    }

    // The inverse transform of a (scratch b), then, Affine, y dp + dF.
    __device__ Cx<T>* inv(Cx<T>* a, Cx<T>* b, const Cx<T>& dp, const Cx<T>& dF) {
        Cx<T>* r = dft<T, true>(c, a, b);
        if constexpr (Affine) ssfm::affine(c, r, dp, dF);
        return r;
    }

    // The drive offset F (e^{Lam0 s} - 1)/Lam0, Lam0 = -(1 + i det), in the
    // plain version's order (models/lle._drive_offset).
    __device__ Cx<T> drive(T s) const {
        T sn, cs;
        ssfm::sin_cos(-det * s, &sn, &cs);
        const T e = exp(-s);
        const Cx<T> m{e * cs - T(1), e * sn};
        return cdiv(Cx<T>{F.re * m.re - F.im * m.im, F.re * m.im + F.im * m.re},
                    Cx<T>{T(-1), -det});
    }

    // Advance over [za, zb].
    __device__ void advance(T za, T zb, int max_steps) {
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
            for (int j = c.tid; j < n; j += c.nt) {
                T s, co;
                ssfm::sin_cos(ph[j] * h4, &s, &co);
                const Cx<T> q{decay * co, decay * s};
                lq[j] = q;
                lc[j] = Cx<T>{q.re * q.re - q.im * q.im, q.re * q.im + q.im * q.re};
                w[0][j] = y[j];
            }
            // the shared forward transform; the fine spectrum into w[2]
            Cx<T>* f = dft<T, false>(c, w[0], w[1]);
            Cx<T>* o = f == w[0] ? w[1] : w[0];
            for (int j = c.tid; j < n; j += c.nt) {
                const Cx<T> F = f[j], a = lq[j], b = lc[j];
                w[2][j] = Cx<T>{a.re * F.re - a.im * F.im, a.re * F.im + a.im * F.re};
                f[j] = Cx<T>{b.re * F.re - b.im * F.im, b.re * F.im + b.im * F.re};
            }
            // coarse: yc = lin(Lc, K_h(IDFT(Lc F)))
            Cx<T>* u = inv(f, o, dp_h, dF_h);
            Cx<T>* uo = u == f ? o : f;
            ssfm::kerr(c, u, g, h);
            Cx<T>* yc = lin(u, uo, lc, dp_h, dF_h);
            Cx<T>* fr = yc == u ? uo : u;
            // fine: yf = lin(Lq, K_{h/2}(lin(Lc, K_{h/2}(IDFT(Lq F)))))
            Cx<T>* v = inv(w[2], fr, dp_q, dF_q);
            Cx<T>* vo = v == w[2] ? fr : w[2];
            ssfm::kerr(c, v, g, hh);
            Cx<T>* v2 = lin(v, vo, lc, dp_h, dF_h);
            ssfm::kerr(c, v2, g, hh);
            Cx<T>* yf = lin(v2, v2 == v ? vo : v, lq, dp_q, dF_q);

            T d2 = T(0), sf = T(0), sy = T(0);
            int fin = 1;
            for (int j = c.tid; j < n; j += c.nt) {
                const Cx<T> a = yf[j], b = yc[j], p = y[j];
                const T dr = a.re - b.re, di = a.im - b.im;
                d2 += dr * dr + di * di;
                sf += a.re * a.re + a.im * a.im;
                sy += p.re * p.re + p.im * p.im;
                fin &= (isfinite(a.re) && isfinite(a.im) && isfinite(b.re) && isfinite(b.im))
                           ? 1 : 0;
            }
            const bool states_finite = __syncthreads_and(fin) != 0;
            const T d = sqrt(ssfm::block_sum(c, d2) / T(n));
            const T mf = ssfm::block_sum(c, sf) / T(n);
            const T my = ssfm::block_sum(c, sy) / T(n);
            const T s = sqrt(ssfm::nan_max(mf, my));
            T denom = atol + rtol * s;
            const T tiny = sizeof(T) == 8 ? T(2.2250738585072014e-308) : T(1.17549435e-38f);
            denom = denom < tiny ? tiny : denom;
            const T enorm = d / denom;
            // the candidate (4 yf - yc)/3, in place of yc
            T sn = T(0);
            for (int j = c.tid; j < n; j += c.nt) {
                const Cx<T> a = yf[j], b = yc[j];
                const Cx<T> yn{(T(4) * a.re - b.re) / T(3), (T(4) * a.im - b.im) / T(3)};
                yc[j] = yn;
                sn += yn.re * yn.re + yn.im * yn.im;
            }
            const bool escape = ssfm::block_sum(c, sn) / T(n) > T(1e30);
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
                for (int i = 0; i < 3; ++i)
                    if (w[i] == yc) w[i] = y;
                y = yc;
                ++n_acc;
            } else {
                ++n_rej;
            }
        }
        if (!(z >= zb)) ok = false;
    }
};

template <typename T, bool Affine>
__global__ void __launch_bounds__(ssfm::kMaxThreads)
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
    Doubling<T, Affine> s;
    s.c.tw = tw;
    s.c.red = reinterpret_cast<T*>(smem);
    s.c.n = n;
    ssfm::split(n, &s.c.m, &s.c.r);
    s.c.tid = threadIdx.x;
    s.c.nt = blockDim.x;
    s.c.inv_n = 1.0 / n;
    Cx<T>* buf = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
    s.y = buf;
    for (int i = 0; i < 3; ++i) s.w[i] = buf + (i + 1) * n;
    s.lq = buf + 4 * n;
    s.lc = buf + 5 * n;
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

template <typename T, bool Affine>
int launch(const void* y0, const void* gamma, const void* alpha, const void* det,
           const void* pump, const void* ph, int ph_stride, const void* tw, void* pk,
           void* y_last, void* ok, void* n_acc, void* n_rej, int B, int n, int n_chunks,
           double seg, double z_end, int has_tail, double dt0, double rtol, double atol,
           int max_steps, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(ssfm_rk45_kernel<T, Affine>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssfm_rk45_kernel<T, Affine>
        <<<B, ssfm::threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Cx<T>*>(y0), static_cast<const T*>(gamma),
        static_cast<const T*>(alpha), static_cast<const T*>(det),
        static_cast<const Cx<T>*>(pump), static_cast<const T*>(ph), ph_stride,
        static_cast<const Cx<double>*>(tw), static_cast<T*>(pk), static_cast<Cx<T>*>(y_last),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(n_acc), static_cast<int32_t*>(n_rej),
        n, n_chunks, seg, z_end, has_tail, dt0, rtol, atol, max_steps);
    return static_cast<int>(cudaGetLastError());
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
