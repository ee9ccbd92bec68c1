// The right-hand side shared by the comb kernels (csrc/comb_rk.cu, K4, and
// csrc/comb_rk45.cu, K5): one thread block evaluates the derivative of one
// comb's state, stacked [Re A | Im A] in shared memory.
//
//   d_re = (-a/2 Ar - beta Ai) - gamma Ti,  d_im = (-a/2 Ai + beta Ar) + gamma Tr,
//   T = (1/L) IDFT(F |F|^2)[0:N],  F = DFT_L(A)   (F^2 conj(F) = F |F|^2),
//
// the terms in the order of models/nwave.make_rhs_nwave and of
// ops/pallas_comb.py:230-240.  Thread j < L forms bin j, thread q < 2N
// derivative component q (q < N the real part of line q, which needs Ti_q;
// q >= N the imaginary part of line q - N, which needs Tr); both loops
// stride by blockDim, so any N whose shared memory fits runs.  The weight of
// (j, m) is tw[(j*m) mod L], the table of cos/sin(2 pi k/L) that
// ops/cuda_comb.py builds from the float64 roots of the plain version's
// dense matrices (models/nwave._dft_mats).  1/L is a power of two, so
// scaling the sum after it rounds as the plain version's scaled weights do.
//
// One RHS is 8*N*L real multiply-adds; this first version sums them with
// scalar FMAs from shared memory, a twiddle load for every two of them.

#pragma once

#include <cuda_runtime.h>

namespace comb {

// At most 256 threads a block: the launch bound then leaves a thread up to
// 255 registers (1024 would cap it at 64 and spill); wider combs loop.
constexpr int kMaxThreads = 256;

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
    T a;
    T b;
};

template <typename T>
struct Block {
    const Pair<T>* tw;  // (L,) cos, sin of 2 pi k / L
    Pair<T>* G;         // (L,) F_j |F_j|^2
    const T* beta;      // (N,)
    int n, L, tid, nt;
    T gamma, nha, inv_L;
};

// d = f(x) for the whole block.  Every thread calls it; it synchronizes on
// entry (x complete) and on exit (x and G no longer read).
template <typename T>
__device__ void rhs(const Block<T>& c, const T* x, T* d) {
    const int n = c.n, mask = c.L - 1;
    __syncthreads();
    for (int j = c.tid; j < c.L; j += c.nt) {
        T fr = T(0), fi = T(0);
        int k = 0;
        for (int m = 0; m < n; ++m) {
            const Pair<T> w = c.tw[k];  // (cos, sin) of 2 pi jm / L
            const T ar = x[m], ai = x[n + m];
            fr += w.a * ar + w.b * ai;
            fi += w.a * ai - w.b * ar;
            k = (k + j) & mask;
        }
        const T mag = fr * fr + fi * fi;
        c.G[j] = Pair<T>{fr * mag, fi * mag};
    }
    __syncthreads();
    for (int q = c.tid; q < 2 * n; q += c.nt) {
        const bool re = q < n;
        const int j = re ? q : q - n;
        T acc = T(0);
        int k = 0;
        if (re) {  // Ti_j = sum_m sin Gr_m + cos Gi_m
            for (int m = 0; m < c.L; ++m) {
                const Pair<T> w = c.tw[k], g = c.G[m];
                acc += w.b * g.a + w.a * g.b;
                k = (k + j) & mask;
            }
            d[q] = (c.nha * x[j] - c.beta[j] * x[n + j]) - c.gamma * (acc * c.inv_L);
        } else {   // Tr_j = sum_m cos Gr_m - sin Gi_m
            for (int m = 0; m < c.L; ++m) {
                const Pair<T> w = c.tw[k], g = c.G[m];
                acc += w.a * g.a - w.b * g.b;
                k = (k + j) & mask;
            }
            d[q] = (c.nha * x[n + j] + c.beta[j] * x[j]) + c.gamma * (acc * c.inv_L);
        }
    }
    __syncthreads();
}

inline int threads_for(int n, int L) {
    const int want = L > 2 * n ? L : 2 * n;
    const int t = (want + 31) / 32 * 32;
    return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace comb
