// The comb's right-hand side through the FFT coupling, comb::Coupling, shared
// by both comb kernels (csrc/comb_rk.cu, K4, and csrc/comb_rk45.cu, K5).  It
// computes
//
//   d_re = (-a/2 Ar - beta Ai) - gamma Ti,  d_im = (-a/2 Ai + beta Ar) + gamma Tr,
//   T = (1/L) IDFT(F |F|^2)[0:N],  F = DFT_L(A)   (F^2 conj(F) = F |F|^2),
//
// the terms in the order of models/nwave.make_rhs_nwave and of
// ops/pallas_comb.py:230-240.  Any L >= 2N - 1 gives the same T[0:N] (the
// circular sum does not alias there; models/nwave._fft_len).
//
// The cubic sum goes through two L-point FFTs computed by the comb's own
// threads, L = max(128, 2^ceil(log2(2N-1))), nt = min(L/4, 256) threads a
// comb.  Thread t owns lines t + i nt, i < L/(2 nt), in registers (lines N ..
// L/2 - 1 are zero), which are exactly the inputs of its first forward pass
// and the kept outputs of its last inverse pass: radix-4 Stockham passes of
// ssfm_common.cuh (one radix-2 pass first when log2 L is odd), a float64
// table of (cos, sin)(2 pi k/L) read through the read-only cache, every
// butterfly in double and rounded once to T as its outputs are stored.  The
// first forward pass reads the thread's lines and skips the zero half; the
// last forward pass forms G = F |F|^2 in the plain version's order before it
// stores; the last inverse pass forms only outputs below L/2, scales them by
// 1/L and hands them to the owning thread, which adds the linear terms.
// Passes end at a barrier of the comb's threads (__syncwarp when the comb is
// one warp, L = 128); the last inverse pass needs none.  At L = 128: 4 passes
// a transform, 7 barriers an RHS, 3 * 128 complex values of shared memory a
// comb.

#pragma once

#include <cuda_runtime.h>

#include "ssfm_common.cuh"

namespace comb {

// At most 256 threads a block: the launch bound then leaves a thread up to
// 255 registers (1024 would cap it at 64 and spill); wider combs loop.
constexpr int kMaxThreads = 256;

// Threads a comb at transform length L (a power of two >= 128), and the
// lines a thread owns.
inline int coupling_threads(int L) { return L / 4 < kMaxThreads ? L / 4 : kMaxThreads; }
inline int coupling_lines(int L) { return L / (2 * coupling_threads(L)); }

// One comb's RHS through the FFT coupling; LPT = L / (2 nt) lines a thread.
template <typename T, int LPT>
struct Coupling {
    using Cx = ssfm::Cx<T>;
    ssfm::Plan f;       // the L-point transform: m = L, r = 1
    Cx *b0, *b1, *b2;   // shared: the pair, and the first forward pass's output
    int n;              // lines
    T gamma, nha;
    T beta[LPT];

    __device__ __forceinline__ int line(int i) const { return f.tid + i * f.nt; }

    // The barrier of the comb's threads.
    __device__ __forceinline__ void sync() const {
        if (f.nt == 32)
            __syncwarp();
        else
            __syncthreads();
    }

    // Whether p holds in every thread of the comb.
    __device__ __forceinline__ bool all(bool p) const {
        return f.nt == 32 ? __all_sync(0xffffffffu, p) != 0 : __syncthreads_and(p) != 0;
    }

    // d = f(x) for the thread's lines.
    __device__ __forceinline__ void rhs(const Cx (&x)[LPT], Cx (&d)[LPT]) const {
        const int L = f.len, h4 = L >> 2;
        // forward, first pass (ns = 1) from the thread's lines; points from
        // L/2 up are the zero padding
        if (f.lm & 1) {  // radix 2: out[2j] = out[2j+1] = x[j]
#pragma unroll
            for (int i = 0; i < LPT; ++i) {
                const int j = line(i);
                const Cx v = j < n ? x[i] : Cx{T(0), T(0)};
                b2[2 * j] = v;
                b2[2 * j + 1] = v;
            }
        } else {         // radix 4 on (x[j], x[j + L/4], 0, 0)
#pragma unroll
            for (int i = 0; i < LPT / 2; ++i) {
                const int j = line(i);
                double xr[4] = {0.0, 0.0, 0.0, 0.0}, xi[4] = {0.0, 0.0, 0.0, 0.0};
                if (j < n) {
                    xr[0] = double(x[i].re);
                    xi[0] = double(x[i].im);
                }
                if (j + h4 < n) {
                    xr[1] = double(x[i + LPT / 2].re);
                    xi[1] = double(x[i + LPT / 2].im);
                }
                ssfm::butterfly<4, false>(xr, xi);
#pragma unroll
                for (int q = 0; q < 4; ++q) b2[4 * j + q] = Cx{T(xr[q]), T(xi[q])};
            }
        }
        sync();
        // forward, the other passes; the last forms G = F |F|^2
        const Cx* src = b2;
        Cx* dst = b0;
        for (int ns = (f.lm & 1) ? 2 : 4; ns < L; ns <<= 2) {
            ssfm::wide_pass<T, false, 4, 1, 2 * LPT>(f, src, dst, ns, ns == h4, Power{});
            sync();
            src = dst;
            dst = dst == b0 ? b1 : b0;
        }
        // inverse, every pass but the last
        int ns = 1;
        if (f.lm & 1) {
            ssfm::wide_pass<T, true, 2, 1, 2 * LPT>(f, src, dst, 1, false, ssfm::NoPost{});
            sync();
            src = dst;
            dst = dst == b0 ? b1 : b0;
            ns = 2;
        }
        for (; ns < h4; ns <<= 2) {
            ssfm::wide_pass<T, true, 4, 1, 2 * LPT>(f, src, dst, ns, false, ssfm::NoPost{});
            sync();
            src = dst;
            dst = dst == b0 ? b1 : b0;
        }
        // inverse, the last pass (radix 4, ns = L/4): outputs j and j + L/4
        // (both below L/2) of butterfly j are the thread's lines i and
        // i + LPT/2; T = that / L, then the linear terms
        const double inv_L = 1.0 / L;
#pragma unroll
        for (int i = 0; i < LPT / 2; ++i) {
            const int j = line(i);
            double xr[4], xi[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const Cx v = src[j + q * h4];
                xr[q] = double(v.re);
                xi[q] = double(v.im);
            }
#pragma unroll
            for (int q = 1; q < 4; ++q) {
                const ssfm::Cx<double> w = ssfm::ldg(&f.tw[q * j]);
                const double tr = xr[q] * w.re - xi[q] * w.im;
                const double ti = xr[q] * w.im + xi[q] * w.re;
                xr[q] = tr;
                xi[q] = ti;
            }
            ssfm::butterfly<4, true>(xr, xi);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int s = i + q * (LPT / 2);
                if (j + q * h4 < n) {
                    const T tr = T(xr[q] * inv_L), ti = T(xi[q] * inv_L);
                    const Cx a = x[s];
                    d[s] = Cx{(nha * a.re - beta[s] * a.im) - gamma * ti,
                              (nha * a.im + beta[s] * a.re) + gamma * tr};
                } else {
                    d[s] = Cx{T(0), T(0)};
                }
            }
        }
    }

    // G = F |F|^2, mag = Fr Fr + Fi Fi as the plain version forms it.
    struct Power {
        __device__ ssfm::Cx<double> operator()(int, int, const ssfm::Cx<double>& v) const {
            const double mag = v.re * v.re + v.im * v.im;
            return ssfm::Cx<double>{v.re * mag, v.im * mag};
        }
    };
};

}  // namespace comb
