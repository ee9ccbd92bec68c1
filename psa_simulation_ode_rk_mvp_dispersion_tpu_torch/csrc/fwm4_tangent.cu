// The 4-wave rotating-frame RK4 in tangent (forward) mode: the state of a
// lane and its derivative along one direction, one CUDA thread a (lane,
// direction).
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
// Design: the directions need nothing from each other, so a thread runs its
// lane's state again beside its own tangent -- no shuffles, no shared
// memory; coefficients, seeds and the initial state are read once and the
// outputs written once.  Every thread of a lane computes the same state and
// direction 0's thread writes it.  What bounds it: a fit has a few hundred
// lanes of 3 directions, far fewer threads than the card holds, so each
// warp has its scheduler to itself and the chain of a step (4 dual RHS
// evaluations and the stage sums) sets the time, n_steps of them in a row.
//
// Layout: structure of arrays, row k of a (rows, n) buffer at k*n; with B
// lanes and D directions, column i = d*B + b is direction d of lane b.
//   coef  (3, B): gamma, alpha, delta_beta      y0    (8, B): re(A1..A4), im(A1..A4)
//   t0    (8, B*D)                              s     (3, B*D)
//   y_end (8, B)                                t_end (8, B*D)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" launchers at the end, each of which returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

#include "fwm4_group.cuh"

namespace fwm4 {

// A value and its derivative along one direction.  The operations the RHS
// template uses (+, -, *, unary -, fma and mul<O>) are overloaded here, in
// the namespace of the template, where argument-dependent lookup finds them
// when fwm4::rhs is instantiated for Dual<T>.
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
    return {a.v * b.v, a.v * b.d + a.d * b.v};
}

// a constant (a step size, a stage weight) times a dual
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) {
    return {a * b.v, a * b.d};
}

template <typename T>
__device__ __forceinline__ Dual<T> fma(Dual<T> a, Dual<T> b, Dual<T> c) {
    return {::fma(a.v, b.v, c.v), (a.v * b.d + a.d * b.v) + c.d};
}

template <Order O, typename T>
__device__ __forceinline__ Dual<T> mul(Dual<T> a, Dual<T> b) {
    return a * b;
}

}  // namespace fwm4

namespace {

constexpr int kThreads = 64;

using fwm4::Coef;
using fwm4::Dual;

template <typename T>
__device__ __forceinline__ void rhs(const Dual<T> (&y)[8], const Coef<Dual<T>>& c,
                                    Dual<T> (&d)[8]) {
    fwm4::rhs<fwm4::Order::kShort>(fwm4::Group<1>(), y, c, d);
}

// The increment of one RK4 step, in the stage order of csrc/fwm4_rk.cu.
template <typename T>
__device__ __forceinline__ void rk4(const Dual<T> (&y)[8], const Coef<Dual<T>>& c, T half_dz,
                                    T dz, T dz_over_6, Dual<T> (&delta)[8]) {
    Dual<T> k1[8], k[8], s[8], yt[8];
    rhs(y, c, k1);
#pragma unroll
    for (int q = 0; q < 8; ++q) yt[q] = y[q] + half_dz * k1[q];
    rhs(yt, c, k);  // k2
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        s[q] = k[q];
        yt[q] = y[q] + half_dz * k[q];
    }
    rhs(yt, c, k);  // k3
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        s[q] = s[q] + k[q];
        yt[q] = y[q] + dz * k[q];
    }
    rhs(yt, c, k);  // k4
#pragma unroll
    for (int q = 0; q < 8; ++q) delta[q] = dz_over_6 * ((k1[q] + T(2) * s[q]) + k[q]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwm4_tangent_kernel(const T* __restrict__ coef, const T* __restrict__ y0,
                    const T* __restrict__ t0, const T* __restrict__ seed,
                    T* __restrict__ y_end, T* __restrict__ t_end, int B, int n_dir, int n_steps,
                    T dz) {
    const size_t n = static_cast<size_t>(B) * static_cast<size_t>(n_dir);
    const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int b = static_cast<int>(i % static_cast<size_t>(B));

    Coef<Dual<T>> c;
    c.gamma = Dual<T>(coef[b], seed[i]);
    c.two_gamma = T(2) * c.gamma;
    c.neg_half_alpha = T(-0.5) * Dual<T>(coef[B + b], seed[n + i]);
    c.neg_half_dbeta = T(-0.5) * Dual<T>(coef[2 * B + b], seed[2 * n + i]);
    const T half_dz = T(0.5) * dz;
    const T dz_over_6 = dz / T(6);

    Dual<T> y[8];
    T comp[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        y[q] = Dual<T>(y0[q * B + b], t0[q * n + i]);
        comp[q] = T(0);
    }
    for (int step = 0; step < n_steps; ++step) {
        Dual<T> delta[8];
        rk4(y, c, half_dz, dz, dz_over_6, delta);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
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
    for (int q = 0; q < 8; ++q) t_end[q * n + i] = y[q].d;
    if (i < static_cast<size_t>(B)) {
#pragma unroll
        for (int q = 0; q < 8; ++q) y_end[q * B + b] = y[q].v;
    }
}

template <typename T>
int launch(const void* coef, const void* y0, const void* t0, const void* seed, void* y_end,
           void* t_end, int B, int n_dir, int n_steps, double dz, void* stream) {
    const size_t n = static_cast<size_t>(B) * static_cast<size_t>(n_dir);
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    fwm4_tangent_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(coef), static_cast<const T*>(y0), static_cast<const T*>(t0),
        static_cast<const T*>(seed), static_cast<T*>(y_end), static_cast<T*>(t_end), B, n_dir,
        n_steps, static_cast<T>(dz));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FWM4_TANGENT_LAUNCHER(NAME, T)                                                     \
    extern "C" int NAME(const void* coef, const void* y0, const void* t0, const void* seed, \
                        void* y_end, void* t_end, int B, int n_dir, int n_steps, double dz, \
                        void* stream) {                                                     \
        return launch<T>(coef, y0, t0, seed, y_end, t_end, B, n_dir, n_steps, dz, stream); \
    }

FWM4_TANGENT_LAUNCHER(fwm4_tangent_f64, double)
FWM4_TANGENT_LAUNCHER(fwm4_tangent_f32, float)
