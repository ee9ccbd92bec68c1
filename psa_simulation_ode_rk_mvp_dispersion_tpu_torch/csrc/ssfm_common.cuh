// Building blocks shared by the split-step Fourier (SSFM) kernels
// csrc/gnlse_ssfm.cu (K6, K7), csrc/ssfm_rk45.cu (K8) and csrc/vgnlse_ssfm.cu
// (K9): one thread block holds one envelope of n complex samples (K9: its two
// polarizations) in shared memory and transforms it with its own FFT.
//
// The transform.  n = m * r with m a power of two (>= 2) and r odd (every n
// that is a multiple of 128 up to 2048 is such a product, r <= 15).  With
// sample index q*r + g and output index k = c*m + d,
//
//   X[c m + d] = sum_g W_n^{g k} Y_g[d],   Y_g[d] = sum_q x[q r + g] W_m^{q d},
//
// so the r decimated sequences go through a radix-2 Stockham FFT of length m
// (log2 m passes, each out of place between two shared buffers; the first
// pass reads x in natural order, the others the group-major layout g*m + d),
// and, for r > 1, one last pass forms each output as an r-term sum over the
// groups with the twiddle W_n^{(g k) mod n}.  The output is in natural
// (fft) order.  Every twiddle is an entry of one float64 table tw[k] = (cos,
// sin)(2 pi k / n), built on the host (ops/cuda_gnlse.twiddles); the forward
// transform uses (cos, -sin), the inverse (cos, sin), and the inverse's last
// pass multiplies by 1/n, as torch.fft.ifft normalizes.  Each butterfly and
// each r-term sum is computed in double and rounded once to the kernel's
// type as it is stored: a float32 table would perturb every transform pair
// by the same fixed rounding, and over a thousand steps that error grows
// linearly.  No library transform is called.
//
// Every pass ends at a __syncthreads(); the functions take and return
// pointers that are the same in every thread of the block.

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

// The DFT (INV false) or the inverse DFT scaled by 1/n (INV true) of P
// sequences of n samples held one after the other, a[s*n : (s+1)*n] (P = 2:
// the two polarizations of csrc/vgnlse_ssfm.cu, transformed in the same
// passes, so that the pair shares each pass's barrier), natural order in,
// natural order out.  a is overwritten and b is scratch; the result is in a
// or b, whichever the function returns.  For P = 1 the sequence index is the
// constant 0.
template <typename T, bool INV, int P = 1>
__device__ Cx<T>* dft(const Block<T>& c, Cx<T>* a, Cx<T>* b) {
    const int n = c.n, m = c.m, r = c.r, hm = m >> 1, half = n >> 1;
    Cx<T>* src = a;
    Cx<T>* dst = b;
    __syncthreads();  // a complete
    for (int ns = 1; ns < m; ns <<= 1) {
        const bool first = ns == 1;
        const bool scale = INV && r == 1 && (ns << 1) == m;
        const int step = (m / (2 * ns)) * r;  // W_{2 ns}^j = W_n^{j step}
        for (int u = c.tid; u < P * half; u += c.nt) {
            const int sq = P == 1 ? 0 : u / half;  // the sequence
            const int t = u - sq * half;
            const Cx<T>* in = src + sq * n;
            Cx<T>* out = dst + sq * n;
            const int g = t / hm, j = t - g * hm, jl = j & (ns - 1);
            const Cx<T> v0 = first ? in[j * r + g] : in[g * m + j];
            const Cx<T> v1 = first ? in[(j + hm) * r + g] : in[g * m + j + hm];
            const Cx<double> w = ldg(&c.tw[jl * step]);
            const double wi = INV ? w.im : -w.im;
            const double tr = double(v1.re) * w.re - double(v1.im) * wi;
            const double ti = double(v1.re) * wi + double(v1.im) * w.re;
            const int o = g * m + ((j - jl) << 1) + jl;
            const double sc = scale ? c.inv_n : 1.0;
            out[o] = Cx<T>{T((v0.re + tr) * sc), T((v0.im + ti) * sc)};
            out[o + ns] = Cx<T>{T((v0.re - tr) * sc), T((v0.im - ti) * sc)};
        }
        Cx<T>* s = src;
        src = dst;
        dst = s;
        __syncthreads();
    }
    if (r > 1) {
        for (int u = c.tid; u < P * n; u += c.nt) {
            const int sq = P == 1 ? 0 : u / n;
            const int k = u - sq * n;
            const Cx<T>* in = src + sq * n;
            const int d = k & (m - 1);
            double ar = 0.0, ai = 0.0;
            int idx = 0;  // (g k) mod n
            for (int g = 0; g < r; ++g) {
                const Cx<T> y = in[g * m + d];
                const Cx<double> w = ldg(&c.tw[idx]);
                const double wi = INV ? w.im : -w.im;
                ar += double(y.re) * w.re - double(y.im) * wi;
                ai += double(y.re) * wi + double(y.im) * w.re;
                idx += k;
                if (idx >= n) idx -= n;
            }
            const double sc = INV ? c.inv_n : 1.0;
            dst[u] = Cx<T>{T(ar * sc), T(ai * sc)};
        }
        Cx<T>* s = src;
        src = dst;
        dst = s;
        __syncthreads();
    }
    return src;
}

// a[k] *= f[k] for the block (a linear factor in the frequency domain), the
// product in the plain version's order: (fr ar - fi ai, fr ai + fi ar).
template <typename T>
__device__ void mul_factor(const Block<T>& c, Cx<T>* a, const Cx<T>* f) {
    for (int k = c.tid; k < c.n; k += c.nt) {
        const Cx<T> x = a[k], w = f[k];
        a[k] = Cx<T>{w.re * x.re - w.im * x.im, w.re * x.im + w.im * x.re};
    }
}

// a[k] <- a[k] dp + dF for the block (the LLE's affine write after an
// inverse transform: detuning rotation and drive offset), in the plain
// version's order, the complex product and then the sum.
template <typename T>
__device__ void affine(const Block<T>& c, Cx<T>* a, const Cx<T>& dp, const Cx<T>& dF) {
    for (int k = c.tid; k < c.n; k += c.nt) {
        const Cx<T> x = a[k];
        a[k] = Cx<T>{(x.re * dp.re - x.im * dp.im) + dF.re, (x.re * dp.im + x.im * dp.re) + dF.im};
    }
}

// Exact Kerr rotation a[k] *= exp(i (g |a_k|^2) h), the angle (g P) h as the
// plain version forms it; sincos is the accurate one (no fast math).
template <typename T>
__device__ void kerr(const Block<T>& c, Cx<T>* a, T g, T h) {
    __syncthreads();
    for (int k = c.tid; k < c.n; k += c.nt) {
        const Cx<T> x = a[k];
        const T ang = (g * (x.re * x.re + x.im * x.im)) * h;
        T s, co;
        sin_cos(ang, &s, &co);
        a[k] = Cx<T>{x.re * co - x.im * s, x.re * s + x.im * co};
    }
}

// Sum over the block of one value a thread, in a fixed order: a shuffle tree
// in each warp, then the warps' sums in warp order.  Every thread gets it.
template <typename T>
__device__ T block_sum(const Block<T>& c, T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    __syncthreads();
    if ((c.tid & 31) == 0) c.red[c.tid >> 5] = v;
    __syncthreads();
    T s = c.red[0];
    for (int w = 1; w < (c.nt >> 5); ++w) s += c.red[w];
    return s;
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

// Copy n samples between global and shared memory (either way).
template <typename T>
__device__ void copy(const Block<T>& c, Cx<T>* dst, const Cx<T>* src) {
    __syncthreads();
    for (int k = c.tid; k < c.n; k += c.nt) dst[k] = src[k];
}

// Split n into m * r, m a power of two and r odd.
__host__ __device__ inline void split(int n, int* m, int* r) {
    int odd = n;
    while ((odd & 1) == 0) odd >>= 1;
    *r = odd;
    *m = n / odd;
}

}  // namespace ssfm
