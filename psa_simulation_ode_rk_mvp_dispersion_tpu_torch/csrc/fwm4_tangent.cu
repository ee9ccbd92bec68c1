// The 4-wave rotating-frame RK4 in tangent (forward) mode: the state of a
// lane and its derivative along one direction, a (lane, direction) on one
// CUDA thread or on a group of 4.
//
// Replaces no TPU kernel.  The JAX package differentiates its lax.scan RK4
// with jax.grad inside one XLA program (parallel/calibrate.py:154-167 for
// the fits, :698-711 for the launch transfers); this kernel is the port's
// counterpart of that program, so that each step of a fit is one launch.
// A fit has 3 parameters and a launch transfer 8 input directions, so
// forward mode -- one tangent a direction, beside the state in registers --
// needs no tape and gives the exact derivative of the same discrete RK4 map.
//
// What it computes (ops/cuda_tangent.py, whose plain version
// solve_tangent_torch computes the same):
//   - the rotating-frame Yaman RHS of csrc/fwm4_group.cuh in the
//     short-chain order of K1/K2 (fwm4::Order::kShort), evaluated on dual
//     numbers (value, derivative): the same template, instantiated for
//     fwm4::Dual<T>, gives the RHS and its Jacobian-vector product from one
//     source;
//   - the RK4 step of csrc/fwm4_rk.cu on the duals, n_steps of them from
//     (y0, t0) with the coefficients (gamma, alpha, delta_beta) seeded by s:
//     dt/dz = J(y) t + sum_k s_k df/dtheta_k;
//   - no NaN freeze and no save grid: the state after the last step
//     (integrate_reduce with check_nan=False and save_every = n_steps);
//   - in float32 only, the state's increment is added with compensated
//     (Kahan) summation, as K2 adds it; the tangent's is added plainly.
//
// Design: the directions need nothing from each other, so a (lane,
// direction) runs its lane's state again beside its own tangent; every
// (lane, direction) computes the same state and direction 0's writes it.
// Coefficients and seeds are read once a thread, the initial state and
// tangent once a thread and owned wave, and the outputs written once.
// What bounds it: a fit has a few hundred lanes of 3 directions, far fewer
// threads than the card holds (200 x 3 is 19 warps), so each warp has its
// scheduler to itself, and a step's dual arithmetic (4 RHS evaluations and
// the stage sums, ~1,600 flop of FP64 at 2 cycles a warp instruction) issued
// by that one warp sets the time, n_steps of them in a row.  Below
// kLaneDirsPerSM (lane, direction)s an SM a (lane, direction) is therefore
// spread over G = 4 threads of one warp, as K3 spreads a lane
// (csrc/fwm4_group.cuh): thread g owns wave g -- its dual state, stages
// and Kahan terms -- and takes the RHS couplings from its group through
// __shfl_sync, one shuffle for a dual's value and one for its derivative.
// The sums run in the one-thread order, so a group gives the bits one
// thread gives.  The tangent has no early exit, so a warp's groups stay on
// one path; a group past the end exits as a whole.  From kLaneDirsPerSM on,
// a (lane, direction) runs on one thread (G = 1), where the shuffles and
// the group's repeated Kerr sum and pair products cost more than the
// shorter chain saves.
//
// Layout: structure of arrays, row k of a (rows, n) buffer at k*n; with B
// lanes and D directions, column i = d*B + b is direction d of lane b.
//   coef  (3, B): gamma, alpha, delta_beta      y0    (8, B): re(A1..A4), im(A1..A4)
//   t0    (8, B*D)                              s     (3, B*D)
//   y_end (8, B)                                t_end (8, B*D)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (ops/_build.py); bound with ctypes through the
// extern "C" launchers at the end, each of which returns cudaGetLastError():
// fwm4_tangent_<type> takes the design by width (fwm4_tangent_group), and
// fwm4_tangent_<type>_g1 / _g4 run one design, for the holds and the A/B.

#include <cuda_runtime.h>

#include <type_traits>

#include "fwm4_group.cuh"

namespace fwm4 {

// A value and its derivative along one direction.  The operations the RHS
// template uses (+, -, *, unary -, fma and mul<O>) are overloaded here, in
// the namespace of the template, where argument-dependent lookup finds them
// when fwm4::rhs is instantiated for Dual<T>.  Their fused multiply-adds,
// and those of the RK4 stage sums, are written out: this source is built with -fmad=false (ops/_build.py),
// so that nvcc contracts nothing on its own: left to contract, it fused
// other products in the code of a lane-direction on one thread than in
// that of a group of four, and the two designs rounded apart (by 1.1e-13
// in fp64 and 4.6e-5 in fp32 at fit-gain's width on an H100; chip_smoke.py
// phase 29).
template <typename T>
struct Dual {
    T v, d;
    Dual() = default;
    __host__ __device__ __forceinline__ Dual(T value, T deriv) : v(value), d(deriv) {}
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
    return {a.v + b.v, a.d + b.d};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
    return {a.v - b.v, a.d - b.d};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
    return {-a.v, -a.d};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
    return {a.v * b.v, ::fma(a.v, b.d, a.d * b.v)};
}

// a constant (a step size, a stage weight) times a dual
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) {
    return {a * b.v, a * b.d};
}

template <typename T>
__device__ __forceinline__ Dual<T> fma(Dual<T> a, Dual<T> b, Dual<T> c) {
    return {::fma(a.v, b.v, c.v), ::fma(a.v, b.d, ::fma(a.d, b.v, c.d))};
}

// a constant times a dual plus a dual: the RK4 stage sums
template <typename T>
__device__ __forceinline__ Dual<T> fma(T a, Dual<T> b, Dual<T> c) {
    return {::fma(a, b.v, c.v), ::fma(a, b.d, c.d)};
}

template <Order O, typename T>
__device__ __forceinline__ Dual<T> mul(Dual<T> a, Dual<T> b) {
    return a * b;
}

// A dual through a group's shuffle (Group<4>::get finds it by
// argument-dependent lookup): the value and the derivative, one each.
template <typename T>
__device__ __forceinline__ Dual<T> __shfl_sync(unsigned mask, Dual<T> v, int src, int width) {
    return {::__shfl_sync(mask, v.v, src, width), ::__shfl_sync(mask, v.d, src, width)};
}

}  // namespace fwm4

namespace {

// Threads a block, both designs.  G = 4 at 64: a narrow launch's warps
// land on as many SM sub-partitions as it has warps (200 x 3
// lane-directions: 75 warps, 2 a block on 38 SMs).  Measured on an H100 at
// fit-gain's width, 32 and 128 threads read within 1.5% of 64; 256 put 2
// warps on each sub-partition of 10 SMs and took 1.6x as long (PERF.md,
// Findings).
constexpr int kThreads = 64;

using fwm4::Coef;
using fwm4::Dual;
using fwm4::Group;

template <int G, typename T>
__device__ __forceinline__ void rhs(const Group<G>& grp, const Dual<T> (&y)[2 * (4 / G)],
                                    const Coef<Dual<T>>& c, Dual<T> (&d)[2 * (4 / G)]) {
    fwm4::rhs<fwm4::Order::kShort>(grp, y, c, d);
}

// The increment of one RK4 step, in the stage order of csrc/fwm4_rk.cu,
// for the owned waves.
template <int G, typename T>
__device__ __forceinline__ void rk4(const Group<G>& grp, const Dual<T> (&y)[2 * (4 / G)],
                                    const Coef<Dual<T>>& c, T half_dz, T dz, T dz_over_6,
                                    Dual<T> (&delta)[2 * (4 / G)]) {
    constexpr int Q = 2 * (4 / G);
    Dual<T> k1[Q], k[Q], s[Q], yt[Q];
    rhs(grp, y, c, k1);
#pragma unroll
    for (int q = 0; q < Q; ++q) yt[q] = fwm4::fma(half_dz, k1[q], y[q]);
    rhs(grp, yt, c, k);  // k2
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        s[q] = k[q];
        yt[q] = fwm4::fma(half_dz, k[q], y[q]);
    }
    rhs(grp, yt, c, k);  // k3
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        s[q] = s[q] + k[q];
        yt[q] = fwm4::fma(dz, k[q], y[q]);
    }
    rhs(grp, yt, c, k);  // k4
#pragma unroll
    for (int q = 0; q < Q; ++q) delta[q] = dz_over_6 * (fwm4::fma(T(2), s[q], k1[q]) + k[q]);
}

// A (lane, direction) on G threads; thread g owns waves g*W .. g*W + W - 1,
// so owned component q (real parts first) is row row(q) of the planes.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
fwm4_tangent_kernel(const T* __restrict__ coef, const T* __restrict__ y0,
                    const T* __restrict__ t0, const T* __restrict__ seed,
                    T* __restrict__ y_end, T* __restrict__ t_end, int B, int n_dir, int n_steps,
                    T dz) {
    constexpr int W = 4 / G, Q = 2 * W;
    const size_t n = static_cast<size_t>(B) * static_cast<size_t>(n_dir);
    const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
    if (i >= n) return;  // the whole group: blockDim is a multiple of G
    const Group<G> grp;
    const int b = static_cast<int>(i % static_cast<size_t>(B));
    const auto row = [&grp](int q) { return q < W ? grp.g * W + q : 4 + grp.g * W + q - W; };

    Coef<Dual<T>> c;
    c.gamma = Dual<T>(coef[b], seed[i]);
    c.two_gamma = T(2) * c.gamma;
    c.neg_half_alpha = T(-0.5) * Dual<T>(coef[B + b], seed[n + i]);
    c.neg_half_dbeta = T(-0.5) * Dual<T>(coef[2 * B + b], seed[2 * n + i]);
    const T half_dz = T(0.5) * dz;
    const T dz_over_6 = dz / T(6);

    Dual<T> y[Q];
    T comp[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        y[q] = Dual<T>(y0[row(q) * B + b], t0[row(q) * n + i]);
        comp[q] = T(0);
    }
    for (int step = 0; step < n_steps; ++step) {
        Dual<T> delta[Q];
        rk4(grp, y, c, half_dz, dz, dz_over_6, delta);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            if constexpr (std::is_same<T, float>::value) {
                const T corrected = delta[q].v - comp[q];
                const T y_new = y[q].v + corrected;
                comp[q] = (y_new - y[q].v) - corrected;
                y[q].v = y_new;
            } else {
                y[q].v = y[q].v + delta[q].v;
            }
            y[q].d = y[q].d + delta[q].d;
        }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) t_end[row(q) * n + i] = y[q].d;
    if (i < static_cast<size_t>(B)) {
#pragma unroll
        for (int q = 0; q < Q; ++q) y_end[row(q) * B + b] = y[q].v;
    }
}

// Threads a (lane, direction) for n of them on the current card: 4 below
// kLaneDirsPerSM an SM, 1 from there on.  Below it a group's warps number
// at most 2 a sub-partition (64 lane-directions an SM are 8 warps of
// groups), and the groups finish first; above it they queue 3 and more
// deep on a sub-partition while one-thread warps still find idle ones.
// Measured on an H100 (chip_smoke.py phase 29's A/B; PERF.md): the group
// 1.13x / 1.20x faster (fp64 / fp32) at 56.8 lane-directions an SM,
// 0.81x / 0.86x at 68.2, 2.0x / 1.6x at fit-gain's 4.5.
constexpr int kLaneDirsPerSM = 64;

int group_size(long long n) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return n >= static_cast<long long>(kLaneDirsPerSM) * sms ? 1 : 4;
}

template <typename T, int G>
int launch(const void* coef, const void* y0, const void* t0, const void* seed, void* y_end,
           void* t_end, int B, int n_dir, int n_steps, double dz, void* stream) {
    const long long n_thr = static_cast<long long>(B) * n_dir * G;
    const unsigned blocks = static_cast<unsigned>((n_thr + kThreads - 1) / kThreads);
    fwm4_tangent_kernel<T, G><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(coef), static_cast<const T*>(y0), static_cast<const T*>(t0),
        static_cast<const T*>(seed), static_cast<T*>(y_end), static_cast<T*>(t_end), B, n_dir,
        n_steps, static_cast<T>(dz));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_by_width(const void* coef, const void* y0, const void* t0, const void* seed,
                    void* y_end, void* t_end, int B, int n_dir, int n_steps, double dz,
                    void* stream) {
    const auto run = group_size(static_cast<long long>(B) * n_dir) == 1 ? launch<T, 1>
                                                                        : launch<T, 4>;
    return run(coef, y0, t0, seed, y_end, t_end, B, n_dir, n_steps, dz, stream);
}

}  // namespace

#define FWM4_TANGENT_LAUNCHER(NAME, T)                                                      \
    extern "C" int NAME(const void* coef, const void* y0, const void* t0, const void* seed, \
                        void* y_end, void* t_end, int B, int n_dir, int n_steps, double dz, \
                        void* stream) {                                                     \
        return launch_by_width<T>(coef, y0, t0, seed, y_end, t_end, B, n_dir, n_steps, dz,  \
                                  stream);                                                  \
    }

#define FWM4_TANGENT_DESIGN(NAME, T, G)                                                     \
    extern "C" int NAME(const void* coef, const void* y0, const void* t0, const void* seed, \
                        void* y_end, void* t_end, int B, int n_dir, int n_steps, double dz, \
                        void* stream) {                                                     \
        return launch<T, G>(coef, y0, t0, seed, y_end, t_end, B, n_dir, n_steps, dz,        \
                            stream);                                                        \
    }

FWM4_TANGENT_LAUNCHER(fwm4_tangent_f64, double)
FWM4_TANGENT_LAUNCHER(fwm4_tangent_f32, float)
FWM4_TANGENT_DESIGN(fwm4_tangent_f64_g1, double, 1)
FWM4_TANGENT_DESIGN(fwm4_tangent_f64_g4, double, 4)
FWM4_TANGENT_DESIGN(fwm4_tangent_f32_g1, float, 1)
FWM4_TANGENT_DESIGN(fwm4_tangent_f32_g4, float, 4)

// The threads a (lane, direction) fwm4_tangent_<type> gives n = B*D of
// them on the current card.
extern "C" int fwm4_tangent_group(long long n) { return group_size(n); }
