// Building blocks shared by the split-step Fourier (SSFM) kernels
// csrc/gnlse_ssfm.cu (K6), csrc/lle_ssfm.cu (K7), csrc/ssfm_rk45.cu (K8) and
// csrc/vgnlse_ssfm.cu (K9), and by the comb coupling csrc/comb_common.cuh
// (K4, K5): one thread block holds one envelope of n complex samples (K9:
// its two polarizations) in shared memory and transforms it with its own FFT.
//
// The transform.  n = m * r with m a power of two (>= 2) and r odd (every n
// that is a multiple of 128 up to 2048 is such a product, r <= 15).  With
// sample index q*r + g and output index k = c*m + d,
//
//   X[c m + d] = sum_g W_n^{g k} Y_g[d],   Y_g[d] = sum_q x[q r + g] W_m^{q d},
//
// so the r decimated sequences go through a Stockham FFT of length m in
// radix-4 passes (one radix-2 pass first when log2 m is odd), each out of
// place between two shared buffers (the first pass reads x in natural order,
// the others the group-major layout g*m + d), and, for r > 1, one last pass
// forms each output as an r-term sum over the groups with the twiddle
// W_n^{(g k) mod n}.  The output is in natural (fft) order.  Every twiddle is
// an entry of one float64 table tw[k] = (cos, sin)(2 pi k / n), built on the
// host (ops/cuda_gnlse.twiddles); the forward transform uses (cos, -sin),
// the inverse (cos, sin).  Each butterfly and each r-term sum is computed in
// double and rounded once to the kernel's type as it is stored: a float32
// table would perturb every transform pair by the same fixed rounding, and
// over a thousand steps that error grows linearly.  No library transform is
// called.  wide_fft stores the last pass's outputs; slot_fft hands each to
// the thread that owns it (see there); both end every pass but the last at
// a __syncthreads(), and take and return pointers that are the same in every
// thread of the block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssfm {

// At most 256 threads a block; every loop strides by the block.
constexpr int kMaxThreads = 256;

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
    T re;
    T im;
};

// The block's view of one envelope's transform.
template <typename T>
struct Block {
    const Cx<double>* tw;  // (n,) in global memory, read through the read-only cache
    T* red;                // (32,) reduction scratch in shared memory
    int n, m, r, tid, nt;
    double inv_n;
};

// A read of a read-only global table through the read-only cache.
__device__ inline Cx<double> ldg(const Cx<double>* p) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    return Cx<double>{v.x, v.y};
}
__device__ inline Cx<float> ldg(const Cx<float>* p) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return Cx<float>{v.x, v.y};
}

// The accurate sine and cosine of one angle (no fast math).
__device__ inline void sin_cos(double a, double* s, double* c) { sincos(a, s, c); }
__device__ inline void sin_cos(float a, float* s, float* c) { sincosf(a, s, c); }

// Threads a block: n/2 butterflies a pass, at most kMaxThreads (n is a
// multiple of 128, so n/2 is a multiple of 32).
inline int threads_for(int n) {
    const int half = n / 2;
    return half < kMaxThreads ? half : kMaxThreads;
}

// The LLE's affine write on one sample, x dp + dF (detuning rotation and
// drive offset), in the plain version's order, the complex product and then
// the sum; and the exact Kerr rotation of one sample, x exp(i (g |x|^2) h),
// the angle (g P) h as the plain version forms it and sincos the accurate
// one (no fast math).  The slotted transforms' last passes apply them
// (csrc/strang.cuh, csrc/ssfm_rk45.cu).
template <typename T>
__device__ __forceinline__ Cx<T> affine_of(const Cx<T>& x, const Cx<T>& dp, const Cx<T>& dF) {
    return Cx<T>{(x.re * dp.re - x.im * dp.im) + dF.re, (x.re * dp.im + x.im * dp.re) + dF.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> kerr_of(const Cx<T>& x, T g, T h) {
    const T ang = (g * (x.re * x.re + x.im * x.im)) * h;
    T s, co;
    sin_cos(ang, &s, &co);
    return Cx<T>{x.re * co - x.im * s, x.re * s + x.im * co};
}

// max(a, b) that keeps a NaN, as torch.maximum and amax do.
template <typename T>
__device__ T nan_max(T a, T b) {
    return (b > a || b != b) ? b : a;
}

// The block's max over samples of |a_k|^2 (a NaN anywhere gives NaN).
template <typename T>
__device__ T block_peak(const Block<T>& c, const Cx<T>* a) {
    __syncthreads();
    T v = a[c.tid].re * a[c.tid].re + a[c.tid].im * a[c.tid].im;  // nt <= n/2
    for (int k = c.tid + c.nt; k < c.n; k += c.nt)
        v = nan_max(v, a[k].re * a[k].re + a[k].im * a[k].im);
    for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_down_sync(0xffffffffu, v, o));
    __syncthreads();
    if ((c.tid & 31) == 0) c.red[c.tid >> 5] = v;
    __syncthreads();
    T s = c.red[0];
    for (int w = 1; w < (c.nt >> 5); ++w) s = nan_max(s, c.red[w]);
    return s;
}

// 1 when every component of a[0:n] is finite, in every thread.
template <typename T>
__device__ bool block_finite(const Block<T>& c, const Cx<T>* a) {
    int fin = 1;
    __syncthreads();
    for (int k = c.tid; k < c.n; k += c.nt) fin &= (isfinite(a[k].re) && isfinite(a[k].im)) ? 1 : 0;
    return __syncthreads_and(fin) != 0;
}

// Split n into m * r, m a power of two and r odd.
__host__ __device__ inline void split(int n, int* m, int* r) {
    int odd = n;
    while ((odd & 1) == 0) odd >>= 1;
    *r = odd;
    *m = n / odd;
}

// ---------------------------------------------------------------------------
// The wide transform of the nl bodies (csrc/gnlse_ssfm.cu's and
// csrc/vgnlse_ssfm.cu's Raman/steepening RK4).  The radix-4 Stockham passes
// of the transform above: a thread loads a butterfly's 4 points into
// registers, turns them by their twiddles, combines them in double and
// stores each output once, rounded to T, with one barrier a pass (at
// n = 1,024, 5 passes, where radix-2 passes would be 10).  The
// caller's Post acts on each output of the last pass in double before it is
// rounded (a linear factor, 1 + omega/omega_0, the inverse's scale), which
// saves a pointwise pass and a rounding.  A Plan also describes the
// half-length transform of a real sequence packed as n/2 complex samples
// (the Raman pair), whose twiddles are every other entry of the table.
// ---------------------------------------------------------------------------

struct Plan {
    const Cx<double>* tw;  // (ntab,) = (cos, sin)(2 pi k / ntab)
    int len, m, r, lm;     // len = m * r samples a sequence, lm = log2 m
    int ntab;              // the table's width: len or 2 len
    int tid, nt;
};

// The plan of a transform of len = ntab / div samples (div 1 or 2).
__device__ inline Plan plan(const Cx<double>* tw, int ntab, int div, int tid, int nt) {
    Plan f;
    f.tw = tw;
    f.ntab = ntab;
    f.len = ntab / div;
    split(f.len, &f.m, &f.r);
    f.lm = 0;
    while ((1 << f.lm) < f.m) ++f.lm;
    f.tid = tid;
    f.nt = nt;
    return f;
}

// Post operations on the last pass's outputs: (sequence, index, value).
struct NoPost {
    __device__ Cx<double> operator()(int, int, const Cx<double>& v) const { return v; }
};
struct Scale {
    double s;
    __device__ Cx<double> operator()(int, int, const Cx<double>& v) const {
        return Cx<double>{v.re * s, v.im * s};
    }
};
// w v in double, the product in the plain version's order:
// (wr vr - wi vi, wr vi + wi vr).
template <typename T>
__device__ __forceinline__ Cx<double> times(const Cx<T>& w, const Cx<double>& v) {
    return Cx<double>{double(w.re) * v.re - double(w.im) * v.im,
                      double(w.re) * v.im + double(w.im) * v.re};
}

// v * f[sq * len + k].
template <typename T>
struct MulBy {
    const Cx<T>* f;
    int len;
    __device__ Cx<double> operator()(int sq, int k, const Cx<double>& v) const {
        return times(f[sq * len + k], v);
    }
};

// v * (1 + inv_w0 omega[k]): the steepening term folded into the spectrum.
template <typename T>
struct Steep {
    const T* omega;
    double inv_w0;
    __device__ Cx<double> operator()(int, int k, const Cx<double>& v) const {
        const double fac = 1.0 + inv_w0 * double(omega[k]);
        return Cx<double>{v.re * fac, v.im * fac};
    }
};

// R-point butterfly in place (R = 2 or 4), the forward or inverse signs.
template <int R, bool INV>
__device__ inline void butterfly(double* xr, double* xi) {
    if constexpr (R == 2) {
        const double r0 = xr[0] + xr[1], i0 = xi[0] + xi[1];
        const double r1 = xr[0] - xr[1], i1 = xi[0] - xi[1];
        xr[0] = r0; xi[0] = i0; xr[1] = r1; xi[1] = i1;
    } else {
        const double a0r = xr[0] + xr[2], a0i = xi[0] + xi[2];
        const double a1r = xr[0] - xr[2], a1i = xi[0] - xi[2];
        const double a2r = xr[1] + xr[3], a2i = xi[1] + xi[3];
        const double a3r = xr[1] - xr[3], a3i = xi[1] - xi[3];
        xr[0] = a0r + a2r; xi[0] = a0i + a2i;
        xr[2] = a0r - a2r; xi[2] = a0i - a2i;
        if (INV) {  // X1 = a1 + i a3, X3 = a1 - i a3
            xr[1] = a1r - a3i; xi[1] = a1i + a3r;
            xr[3] = a1r + a3i; xi[3] = a1i - a3r;
        } else {    // X1 = a1 - i a3, X3 = a1 + i a3
            xr[1] = a1r + a3i; xi[1] = a1i - a3r;
            xr[3] = a1r - a3i; xi[3] = a1i + a3r;
        }
    }
}

// One radix-R Stockham pass over P sequences: R sub-transforms of ns points
// become one of R ns.  Butterfly j of group g reads points j + q m/R (the
// first pass in natural order, q r + g, the others group-major g m + .),
// turns point q by W_{R ns}^{q (j mod ns)} and writes output q at
// g m + (j - j mod ns) R + j mod ns + q ns.  S is the samples a thread of
// one sequence (S nt >= len): a thread takes butterflies tid + i nt,
// i < ceil(P S / R), in a loop that unrolls; m/R is a power of two, so a
// butterfly's group and index are a shift and a mask.
template <typename T, bool INV, int R, int P, int S, class Post>
__device__ __forceinline__ void wide_pass(const Plan& f, const Cx<T>* src, Cx<T>* dst, int ns,
                                          bool last, const Post& post) {
    constexpr int kLogR = R == 2 ? 1 : 2;
    constexpr int kButterflies = (P * S + R - 1) / R;
    const int lmR = f.lm - kLogR, mR = 1 << lmR, per = f.r << lmR;
    const int step = f.ntab / (R * ns);
#pragma unroll
    for (int b = 0; b < kButterflies; ++b) {
        const int u = f.tid + b * f.nt;
        if (u < P * per) {
            const int sq = P == 1 ? 0 : u / per;
            const int t = u - sq * per;
            const int g = t >> lmR, j = t & (mR - 1), k = j & (ns - 1);
            const Cx<T>* in = src + sq * f.len;
            Cx<T>* out = dst + sq * f.len;
            double xr[R], xi[R];
#pragma unroll
            for (int q = 0; q < R; ++q) {
                const int i = j + q * mR;
                const Cx<T> v = ns == 1 ? in[i * f.r + g] : in[g * f.m + i];
                xr[q] = double(v.re);
                xi[q] = double(v.im);
            }
            if (ns > 1) {
#pragma unroll
                for (int q = 1; q < R; ++q) {
                    const Cx<double> w = ldg(&f.tw[q * k * step]);
                    const double wi = INV ? w.im : -w.im;
                    const double tr = xr[q] * w.re - xi[q] * wi;
                    const double ti = xr[q] * wi + xi[q] * w.re;
                    xr[q] = tr;
                    xi[q] = ti;
                }
            }
            butterfly<R, INV>(xr, xi);
            const int o = g * f.m + (j - k) * R + k;
#pragma unroll
            for (int q = 0; q < R; ++q) {
                Cx<double> v{xr[q], xi[q]};
                if (last) v = post(sq, o + q * ns, v);
                out[o + q * ns] = Cx<T>{T(v.re), T(v.im)};
            }
        }
    }
}

// The DFT (INV false) or the unscaled inverse DFT (INV true; the caller's
// Post scales) of P sequences of f.len samples held one after the other,
// natural order in and out.  a is overwritten and b is scratch; the result is
// in a or b, whichever the function returns.  Every pass ends at a barrier.
// S: the samples a thread of one sequence, as for wide_pass.
template <typename T, bool INV, int P, int S, class Post>
__device__ __forceinline__ Cx<T>* wide_fft(const Plan& f, Cx<T>* a, Cx<T>* b, const Post& post) {
    const bool tail = f.r > 1;
    Cx<T>* src = a;
    Cx<T>* dst = b;
    int ns = 1;
    __syncthreads();  // a complete
    if (f.lm & 1) {
        wide_pass<T, INV, 2, P, S>(f, src, dst, 1, !tail && f.m == 2, post);
        Cx<T>* s = src;
        src = dst;
        dst = s;
        ns = 2;
        __syncthreads();
    }
    for (; ns < f.m; ns <<= 2) {
        wide_pass<T, INV, 4, P, S>(f, src, dst, ns, !tail && (ns << 2) == f.m, post);
        Cx<T>* s = src;
        src = dst;
        dst = s;
        __syncthreads();
    }
    if (tail) {
        const int tws = f.ntab / f.len;
        for (int u = f.tid; u < P * f.len; u += f.nt) {
            const int sq = P == 1 ? 0 : u / f.len;
            const int k = u - sq * f.len;
            const Cx<T>* in = src + sq * f.len;
            const int d = k & (f.m - 1), inc = k * tws;
            double ar = 0.0, ai = 0.0;
            int idx = 0;  // (g k tws) mod ntab
            for (int g = 0; g < f.r; ++g) {
                const Cx<T> y = in[g * f.m + d];
                const Cx<double> w = ldg(&f.tw[idx]);
                const double wi = INV ? w.im : -w.im;
                ar += double(y.re) * w.re - double(y.im) * wi;
                ai += double(y.re) * wi + double(y.im) * w.re;
                idx += inc;
                if (idx >= f.ntab) idx -= f.ntab;
            }
            const Cx<double> v = post(sq, k, Cx<double>{ar, ai});
            dst[u] = Cx<T>{T(v.re), T(v.im)};
        }
        Cx<T>* s = src;
        src = dst;
        dst = s;
        __syncthreads();
    }
    return src;
}

// The middle of the Raman pair R = Re IDFT(hrc DFT(p)) for a real p of n
// samples, in place on z: on entry Z = DFT_{n/2}(p[2q] + i p[2q+1]) (natural
// order, f the half-length plan, f.ntab = n); on exit Z' with
// IDFT_{n/2}(Z') / 2 = r[2q] + i r[2q+1].  A thread takes the pair (k, n/2 -
// k): it unpacks X[k] = (Z[k] + Z*[M-k])/2 + W_n^k (Z[k] - Z*[M-k])/(2i) and
// X[M-k] (M = n/2), multiplies by hrc, drops the imaginary parts at 0 and M
// as a real inverse transform does, and packs Y back:
// Z'[k] = Y[k] + Y*[M-k] + i (Y[k] - Y*[M-k]) W_n^{-k}.  All in double.
template <typename T>
__device__ __forceinline__ void raman_spectrum(const Plan& f, Cx<T>* z, const Cx<T>* hrc) {
    const int M = f.len;
    for (int k = f.tid; k <= M / 2; k += f.nt) {
        if (k == 0) {
            const double x0 = double(z[0].re) + double(z[0].im);
            const double xm = double(z[0].re) - double(z[0].im);
            const double y0 = double(hrc[0].re) * x0, ym = double(hrc[M].re) * xm;
            z[0] = Cx<T>{T(y0 + ym), T(y0 - ym)};
            continue;
        }
        const Cx<T> zk = z[k], zc = z[M - k];
        const double er = 0.5 * (double(zk.re) + double(zc.re));
        const double ei = 0.5 * (double(zk.im) - double(zc.im));
        const double orr = 0.5 * (double(zk.im) + double(zc.im));
        const double oi = -0.5 * (double(zk.re) - double(zc.re));
        const Cx<double> w = ldg(&f.tw[k]);  // W_n^k = (w.re, -w.im)
        const double tr = w.re * orr + w.im * oi, ti = w.re * oi - w.im * orr;
        const double xr = er + tr, xi = ei + ti;     // X[k]
        const double xcr = er - tr, xci = ti - ei;   // X[M-k] = conj(Xe - t)
        const Cx<T> hk = hrc[k], hc = hrc[M - k];
        const double yr = double(hk.re) * xr - double(hk.im) * xi;
        const double yi = double(hk.re) * xi + double(hk.im) * xr;
        const double ycr = double(hc.re) * xcr - double(hc.im) * xci;
        const double yci = double(hc.re) * xci + double(hc.im) * xcr;
        const double er2 = yr + ycr, ei2 = yi - yci;  // E = Y[k] + conj(Y[M-k])
        const double dr = yr - ycr, di = yi + yci;    // Y[k] - conj(Y[M-k])
        const double orr2 = dr * w.re - di * w.im, oi2 = dr * w.im + di * w.re;  // O = d W_n^{-k}
        z[k] = Cx<T>{T(er2 - oi2), T(ei2 + orr2)};                  // E + i O
        if (M - k != k) z[M - k] = Cx<T>{T(er2 + oi2), T(orr2 - ei2)};  // E* + i O*
    }
}

// ---------------------------------------------------------------------------
// The slotted transform of csrc/strang.cuh (K6 Kerr, K7, K9 rotation and
// coherent) and csrc/ssfm_rk45.cu (K8): wide_fft's passes, but the input is
// read from a buffer the transform leaves alone (the first pass reads in, the
// others ping-pong between s0 and s1; in may be s1, not s0), and the last
// pass hands each output to the caller's Post with its slot instead of
// storing it.  Thread tid owns the same outputs of the last pass in every
// transform of one plan:
//   r = 1 (the last pass is radix-4 at ns = len/4): slot s is output
//     tid + (s/4) nt + (s%4) len/4, for the butterflies tid + (s/4) nt
//     below len/4;
//   r > 1 (the last pass is the r-term tail): slot s is output tid + s nt,
//     s < S, below len.
// S, the samples a thread (4 or 8), is a template constant and every slot
// loop unrolls, so that the caller keeps per-sample values (factors, a state)
// in registers of the thread that owns the sample.  Post(s, k, v, out)
// gets the slot, the output index, the value in double and the buffer that
// is free for the outputs (the one of s0, s1 the last pass does not read),
// and stores what it wants.  With P = 2 sequences (K9's polarizations, one
// after the other, len apart) every pass computes each sequence with the
// P = 1 pass's operations, one barrier serves both, and the thread that owns
// output k owns it in both: v is then the pair of values {v_0, v_1}.  A
// barrier follows the last pass when Sync.
// ---------------------------------------------------------------------------

// The samples a thread at width n: 4 up to n = 1,024, 8 above.
inline int default_slots(int n) { return n <= 4 * kMaxThreads ? 4 : 8; }

// Threads a block at width n with S samples a thread (n/S rounded up to
// whole warps), or 0 when that block does not cover n within kMaxThreads.
inline int block_threads(int n, int S) {
    const int nt = ((n + S - 1) / S + 31) / 32 * 32;
    return nt > kMaxThreads ? 0 : nt;
}

// The launch bounds of a slotted kernel: a Narrow block (at most 128
// threads) any registers; a wide one (up to 256) two blocks an SM at 4
// samples a thread (at most 128 registers), one at 8.
template <int S, bool Narrow>
struct Bounds {
    static constexpr int kThreads = Narrow ? 128 : kMaxThreads;
    static constexpr int kBlocks = Narrow || S == 8 ? 1 : 2;
};

// The output index of slot s.
__device__ __forceinline__ int slot_sample(const Plan& f, int s) {
    return f.r == 1 ? f.tid + (s >> 2) * f.nt + (s & 3) * (f.len >> 2) : f.tid + s * f.nt;
}

// Whether slot s of this thread holds an output.
template <int S>
__device__ __forceinline__ bool slot_valid(const Plan& f, int s) {
    return f.r == 1 ? f.tid + (s >> 2) * f.nt < (f.len >> 2) : (s < S && f.tid + s * f.nt < f.len);
}

// Post(s, k, v, out) with the outputs of the P sequences at index k: v
// itself for one sequence, the pair for two.
template <int P, class Post, typename T>
__device__ __forceinline__ void post_of(const Post& post, int s, int k, const Cx<double> (&v)[P],
                                        Cx<T>* out) {
    if constexpr (P == 1)
        post(s, k, v[0], out);
    else
        post(s, k, v, out);
}

// The last radix-4 pass (r = 1, ns = len/4), as wide_pass computes it.
template <typename T, bool INV, int S, int P, class Post>
__device__ __forceinline__ void slot_last4(const Plan& f, const Cx<T>* src, Cx<T>* out,
                                           const Post& post) {
    constexpr int kButterflies = S / 4;
    const int q4 = f.len >> 2, step = f.ntab == f.len ? 1 : f.ntab / f.len;
#pragma unroll
    for (int i = 0; i < kButterflies; ++i) {
        const int j = f.tid + i * f.nt;
        if (j < q4) {
            double xr[P][4], xi[P][4];
#pragma unroll
            for (int p = 0; p < P; ++p) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const Cx<T> v = src[p * f.len + j + q * q4];
                    xr[p][q] = double(v.re);
                    xi[p][q] = double(v.im);
                }
#pragma unroll
                for (int q = 1; q < 4; ++q) {
                    const Cx<double> w = ldg(&f.tw[q * j * step]);
                    const double wi = INV ? w.im : -w.im;
                    const double tr = xr[p][q] * w.re - xi[p][q] * wi;
                    const double ti = xr[p][q] * wi + xi[p][q] * w.re;
                    xr[p][q] = tr;
                    xi[p][q] = ti;
                }
                butterfly<4, INV>(xr[p], xi[p]);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                Cx<double> v[P];
#pragma unroll
                for (int p = 0; p < P; ++p) v[p] = Cx<double>{xr[p][q], xi[p][q]};
                post_of<P>(post, 4 * i + q, j + q * q4, v, out);
            }
        }
    }
}

// The r-term tail (r > 1), as wide_fft computes it.
template <typename T, bool INV, int S, int P, class Post>
__device__ __forceinline__ void slot_tail(const Plan& f, const Cx<T>* src, Cx<T>* out,
                                          const Post& post) {
    const int tws = f.ntab / f.len;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int k = f.tid + s * f.nt;
        if (k < f.len) {
            const int d = k & (f.m - 1), inc = k * tws;
            Cx<double> v[P];
#pragma unroll
            for (int p = 0; p < P; ++p) {
                double ar = 0.0, ai = 0.0;
                int idx = 0;  // (g k tws) mod ntab
                for (int g = 0; g < f.r; ++g) {
                    const Cx<T> y = src[p * f.len + g * f.m + d];
                    const Cx<double> w = ldg(&f.tw[idx]);
                    const double wi = INV ? w.im : -w.im;
                    ar += double(y.re) * w.re - double(y.im) * wi;
                    ai += double(y.re) * wi + double(y.im) * w.re;
                    idx += inc;
                    if (idx >= f.ntab) idx -= f.ntab;
                }
                v[p] = Cx<double>{ar, ai};
            }
            post_of<P>(post, s, k, v, out);
        }
    }
}

// The DFT (INV false) or the unscaled inverse DFT (INV true) of the P
// sequences of in, natural order in and out; returns the buffer Post was
// handed.  Every pass but the last ends at a barrier, the last one when Sync.
template <typename T, bool INV, int S, bool Sync, int P = 1, class Post>
__device__ __forceinline__ Cx<T>* slot_fft(const Plan& f, const Cx<T>* in, Cx<T>* s0, Cx<T>* s1,
                                           const Post& post) {
    static_assert(S == 4 || S == 8, "a thread owns whole radix-4 butterflies");
    const Cx<T>* src = in;
    Cx<T>* dst = s0;
    int ns = 1;
    if (f.lm & 1) {
        wide_pass<T, INV, 2, P, S>(f, src, dst, 1, false, NoPost{});
        __syncthreads();
        src = dst;
        dst = dst == s0 ? s1 : s0;
        ns = 2;
    }
    const int stop = f.r > 1 ? f.m : f.m >> 2;  // the radix-4 passes before the last
    for (; ns < stop; ns <<= 2) {
        wide_pass<T, INV, 4, P, S>(f, src, dst, ns, false, NoPost{});
        __syncthreads();
        src = dst;
        dst = dst == s0 ? s1 : s0;
    }
    if (f.r > 1)
        slot_tail<T, INV, S, P>(f, src, dst, post);
    else
        slot_last4<T, INV, S, P>(f, src, dst, post);
    if (Sync) __syncthreads();
    return dst;
}

}  // namespace ssfm
