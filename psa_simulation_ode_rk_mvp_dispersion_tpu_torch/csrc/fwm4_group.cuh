// A 4-wave lane spread over a group of G threads of one warp, and the
// rotating-frame Yaman RHS computed by such a group.  Shared by
// csrc/fwm4_rk.cu (K1/K2) and csrc/fwm4_rk45.cu (K3).
//
// A lane runs on one thread (G = 1) or on G = 4, thread g owning wave g.
// A thread owns W = 4 / G waves, g*W .. g*W + W - 1, and a state, stage or
// derivative of the lane is, in each thread, an array of 2W reals: the
// owned waves' real parts [0, W) and imaginary parts [W, 2W).  The
// couplings of the RHS -- the four powers of the Kerr sum, the conjugate
// partner's amplitude and the other pair's product of the FWM term -- come
// from the owning threads through __shfl_sync with width G.  A shuffle
// moves bits unchanged and every thread sums gathered values in the order
// the one-thread RHS sums them, so a group computes each value by the same
// operations as one thread does, and every thread of a group holds the same
// Kerr sum and, in the kernels, the same error norm, step and counters: a
// group never diverges.
//
// Every shuffle names the whole warp (kFullMask), so nvcc emits a plain
// SHFL; a shuffle whose mask is a run-time value compiles to a collective
// sequence (WARPSYNC, BSSY/BSYNC, ENDCOLLECTIVE) around each SHFL, which
// cost more than the arithmetic it moves.  So the kernels keep every
// thread of a warp that has not exited on the same path at each shuffle:
// a group's loops run while any lane of the warp is active, and a finished
// lane's group computes along without committing.
//
// Order: how a kernel's RHS rounds.  kExact -- the plain version's term
// order, every product through __fmul_rn / __dmul_rn, which nvcc never
// contracts into a fused multiply-add, so that a kernel built with FMA still
// rounds every product and sum apart as its plain version does; kPlain --
// the same order, products free to contract; kShort -- the order chosen for
// the length of the dependency chain (rhs below).

#pragma once

#include <cuda_runtime.h>

namespace fwm4 {

constexpr unsigned kFullMask = 0xffffffffu;

enum class Order { kExact, kPlain, kShort };

template <int G>
struct Group {
    static_assert(G == 1 || G == 4, "a lane runs on 1 thread or on 4");
    static constexpr int W = 4 / G;  // waves a thread owns
    int g;                            // the thread's rank in the group

    __device__ __forceinline__ Group() : g(static_cast<int>(threadIdx.x) & (G - 1)) {}

    // v as thread src of the group holds it; every thread of the warp that
    // has not exited calls it together
    template <typename V>
    __device__ __forceinline__ V get(V v, int src) const {
        if constexpr (G == 1) {
            return v;
        } else {
            return __shfl_sync(kFullMask, v, src, G);
        }
    }

    // p AND-ed over the group
    __device__ __forceinline__ bool all(bool p) const {
        int v = p ? 1 : 0;
#pragma unroll
        for (int o = 1; o < G; o <<= 1) v &= get(v, g ^ o);
        return v != 0;
    }
};

template <Order O>
__device__ __forceinline__ float mul(float a, float b) {
    if constexpr (O == Order::kExact) {
        return __fmul_rn(a, b);
    } else {
        return a * b;
    }
}

template <Order O>
__device__ __forceinline__ double mul(double a, double b) {
    if constexpr (O == Order::kExact) {
        return __dmul_rn(a, b);
    } else {
        return a * b;
    }
}

template <typename T>
struct Coef {
    T gamma;
    T two_gamma;
    T neg_half_alpha;
    T neg_half_dbeta;  // pump detuning
};

template <typename T>
__device__ __forceinline__ Coef<T> load_coef(const T* __restrict__ coef, int B, int b) {
    Coef<T> c;
    c.gamma = coef[b];
    c.two_gamma = T(2) * c.gamma;
    c.neg_half_alpha = T(-0.5) * coef[B + b];
    c.neg_half_dbeta = T(-0.5) * coef[2 * B + b];
    return c;
}

// |A_j|^2 of each owned wave
template <Order O, int G, typename T>
__device__ __forceinline__ void powers(const T (&y)[2 * (4 / G)], T (&P)[4 / G]) {
    constexpr int W = 4 / G;
#pragma unroll
    for (int w = 0; w < W; ++w) P[w] = mul<O>(y[w], y[w]) + mul<O>(y[W + w], y[W + w]);
}

// t_j = conj(a_{j^1}) * (the product of the other pair) for the owned
// waves: the FWM drive, with s12 = a1*a2 and s34 = a3*a4 formed as
// (r_lo*r_hi - i_lo*i_hi, r_lo*i_hi + i_lo*r_hi)
template <Order O, int G, typename T>
__device__ __forceinline__ void drive(const Group<G>& grp, const T (&y)[2 * (4 / G)],
                                      T (&t_re)[4 / G], T (&t_im)[4 / G]) {
    constexpr int W = 4 / G;
    const auto m = [](T a, T b) { return mul<O>(a, b); };
    const auto conj_times = [&m](T pr, T pi, T s_re, T s_im, T& tr, T& ti) {
        tr = m(pr, s_re) + m(pi, s_im);
        ti = m(pr, s_im) - m(pi, s_re);
    };
    if constexpr (W == 4) {
        const T r1 = y[0], r2 = y[1], r3 = y[2], r4 = y[3];
        const T i1 = y[4], i2 = y[5], i3 = y[6], i4 = y[7];
        const T s34_re = m(r3, r4) - m(i3, i4), s34_im = m(r3, i4) + m(i3, r4);
        const T s12_re = m(r1, r2) - m(i1, i2), s12_im = m(r1, i2) + m(i1, r2);
        conj_times(r2, i2, s34_re, s34_im, t_re[0], t_im[0]);
        conj_times(r1, i1, s34_re, s34_im, t_re[1], t_im[1]);
        conj_times(r4, i4, s12_re, s12_im, t_re[2], t_im[2]);
        conj_times(r3, i3, s12_re, s12_im, t_re[3], t_im[3]);
    } else {
        // wave g; its partner from thread g ^ 1, the other pair's product
        // from thread g ^ 2 (lo is the even wave of a pair)
        const T pr = grp.get(y[0], grp.g ^ 1), pi = grp.get(y[1], grp.g ^ 1);
        const bool lo = (grp.g & 1) == 0;
        const T rl = lo ? y[0] : pr, il = lo ? y[1] : pi;
        const T rh = lo ? pr : y[0], ih = lo ? pi : y[1];
        const T s_re = m(rl, rh) - m(il, ih), s_im = m(rl, ih) + m(il, rh);
        const T o_re = grp.get(s_re, grp.g ^ 2), o_im = grp.get(s_im, grp.g ^ 2);
        conj_times(pr, pi, o_re, o_im, t_re[0], t_im[0]);
    }
}

// d = f(y) for the owned waves: loss, Kerr (F = 2*sum(P) - P), FWM
// i 2g [conj(a2) s34, conj(a1) s34, conj(a4) s12, conj(a3) s12], and the
// pump detuning -i*dbeta/2 on waves 1 and 2.
//
// kExact and kPlain: in the term order of the one-thread RHS
// (pallas_solver.py:54-93; ops/rhs.rhs_yaman_autonomous).  kShort: the
// order is chosen for the length of the dependency chain, which is what a
// lane's step waits on (a lane alone on its warp scheduler): the Kerr
// sum as (P1 + P2) + (P3 + P4), gF = fma(-g, P, 2g sum(P)), and the loss,
// FWM and detuning terms summed while the sum is formed, so that a
// component waits for the powers through 4 operations after them, not 7.
template <Order O, int G, typename T>
__device__ __forceinline__ void rhs(const Group<G>& grp, const T (&y)[2 * (4 / G)],
                                    const Coef<T>& c, T (&d)[2 * (4 / G)]) {
    constexpr int W = 4 / G;
    const auto m = [](T a, T b) { return mul<O>(a, b); };
    T P[W];
    powers<O, G>(y, P);
    T Pj[4];  // the four powers, each from its owner
#pragma unroll
    for (int j = 0; j < 4; ++j) Pj[j] = grp.get(P[j % W], j / W);
    T t_re[W], t_im[W];
    drive<O>(grp, y, t_re, t_im);
    if constexpr (O != Order::kShort) {
        const T two_tot = m(T(2), ((Pj[0] + Pj[1]) + Pj[2]) + Pj[3]);
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const T gF = m(c.gamma, two_tot - P[w]);
            d[w] = m(c.neg_half_alpha, y[w]) - m(gF, y[W + w]);
            d[W + w] = m(c.neg_half_alpha, y[W + w]) + m(gF, y[w]);
            d[w] = d[w] - m(c.two_gamma, t_im[w]);
            d[W + w] = d[W + w] + m(c.two_gamma, t_re[w]);
            // the pumps, waves 1 and 2: selected, so that the warp stays on one path
            const bool pump = grp.g * W + w < 2;
            const T dr = d[w] - m(c.neg_half_dbeta, y[W + w]);
            const T di = d[W + w] + m(c.neg_half_dbeta, y[w]);
            d[w] = pump ? dr : d[w];
            d[W + w] = pump ? di : d[W + w];
        }
    } else {
        const T two_g_tot = c.two_gamma * ((Pj[0] + Pj[1]) + (Pj[2] + Pj[3]));
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const T re = y[w], im = y[W + w];
            const bool pump = grp.g * W + w < 2;
            T xr = c.two_gamma * t_im[w], xi = c.two_gamma * t_re[w];
            xr = pump ? fma(c.neg_half_dbeta, im, xr) : xr;
            xi = pump ? fma(c.neg_half_dbeta, re, xi) : xi;
            xr = fma(c.neg_half_alpha, re, -xr);
            xi = fma(c.neg_half_alpha, im, xi);
            const T gF = fma(-c.gamma, P[w], two_g_tot);
            d[w] = fma(-gF, im, xr);
            d[W + w] = fma(gF, re, xi);
        }
    }
}

}  // namespace fwm4
