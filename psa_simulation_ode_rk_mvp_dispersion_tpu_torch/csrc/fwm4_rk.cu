// Batched 4-wave FWM integration in the rotating (autonomous) frame:
// RK4, AB4 or ABM4, one CUDA thread per instance.
//
// Replaces the JAX package's TPU kernels
//   ops/pallas_df32.py::_kernel_body_grouped   (K1, the <=1e-9 tier; here fp64)
//   ops/pallas_solver.py::_kernel_body_grouped (K2, the x32 tier; here fp32)
// with one template, fwm4_rk_kernel<T, METHOD>, T in {double, float}.
//
// Design: each thread keeps its instance's state, RK stages, Adams history,
// running P_max and last saved state in registers for all n_steps;
// coefficients and y0 are read once at the start and the outputs written
// once at the end, so the step loop moves no memory at all.  A lane's steps
// are serial, and at the main path's 10^4 lanes (313 warps on the H100's
// 528 warp schedulers) each warp has its scheduler to itself: a step costs
// the lane's chain of 4 RHS evaluations and the stage sums, issued by one
// warp.  The RHS (csrc/fwm4_group.cuh) therefore runs in the order with the
// shortest chain (fwm4::Order::kShort), not the plain version's; the
// results stay within the plain version's bars (rounding only).  A lane
// spread over 2 or 4 threads of a warp, as the rk45 kernel's is, measured
// within 4% at 1,000-4,000 lanes and slower from 10^4 lanes on: a
// fixed-step warp already keeps its scheduler's issue slots busy, and a
// group's shuffles and repeated work cost more than they save (PERF.md).
// What bounds it: FP64 (or FP32) issue on the schedulers that hold a warp.
//
// What it computes (the contract of ops/integrators.integrate_reduce and of
// the TPU kernels it replaces):
//   - the rotating-frame Yaman RHS, terms in the order of
//     pallas_solver.py:54-93: loss, Kerr (F = 2*sum(P) - P), FWM with
//     conj(a2)*a3*a4 ..., then the pump detuning -i*dbeta/2;
//   - RK4: y + dz/6 * (k1 + 2*(k2 + k3) + k4);
//   - AB4/ABM4: 3 RK4 startup steps that record k1 = f(y_n), then
//     y + dz/24*(55 f0 - 59 f1 + 37 f2 - 9 f3), and for ABM4 the corrector
//     y + dz/24*(9 f(y_pred) + 19 f0 - 5 f1 + f2) (integrators._ms_bootstrap,
//     pallas_df32.py:569-606);
//   - in float32 only, each step's increment is added to the state with
//     compensated (Kahan) summation, as ops/integrators.py does: the
//     rounding of y + increment is the dominant float32 error over thousands
//     of steps.  float64 adds it plainly, as the reference does;
//   - with check_nan set, after every step a lane whose new state has a
//     non-finite component keeps its last finite state and clears ok; with
//     it clear, the state is taken as it comes and ok stays set;
//   - at every step multiple of save_every, P_max = max(P_max, |y|^2) and
//     y_last = y; both start from y0, and the trailing n_steps % save_every
//     steps are integrated but feed only ok (pallas_df32.py:522-557).
//
// Layout: structure of arrays, row k of a (rows, B) buffer at k*B, so
// neighbouring threads touch neighbouring addresses.
//   coef  (3, B): gamma, alpha, delta_beta
//   y0    (8, B): re(A1..A4), im(A1..A4)
//   pmax  (4, B), y_last (8, B) in the same order, ok (B,) uint8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" launchers at the end, each of which returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fwm4_group.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRK4 = 0;
constexpr int kAB4 = 1;
constexpr int kABM4 = 2;

// Compensated summation of the state update, float32 only.
template <typename T>
constexpr bool kCompensated = std::is_same<T, float>::value;

using fwm4::Coef;

// d = f(y); y[0..3] real parts, y[4..7] imaginary parts, in the order with
// the shortest dependency chain (csrc/fwm4_group.cuh).
template <typename T>
__device__ __forceinline__ void rhs(const T (&y)[8], const Coef<T>& c, T (&d)[8]) {
    fwm4::rhs<fwm4::Order::kShort>(fwm4::Group<1>(), y, c, d);
}

// The increment of one RK4 step; k1 = f(y) is handed back for the Adams
// startup history.
template <typename T>
__device__ __forceinline__ void rk4(const T (&y)[8], const Coef<T>& c, T half_dz, T dz,
                                    T dz_over_6, T (&delta)[8], T (&k1)[8]) {
    T k[8], s[8], yt[8];
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
        s[q] += k[q];
        yt[q] = y[q] + dz * k[q];
    }
    rhs(yt, c, k);  // k4
#pragma unroll
    for (int q = 0; q < 8; ++q) delta[q] = dz_over_6 * ((k1[q] + T(2) * s[q]) + k[q]);
}

// Per-step tail: the update y += delta (compensated in float32), NaN
// freeze, then the save-grid reductions when the step count reaches a
// multiple of save_every (to_save counts down to it).  comp carries the
// rounding error of y; it stays 0 in float64.
template <typename T>
__device__ __forceinline__ void keep(T (&y)[8], T (&comp)[8], const T (&delta)[8], bool& ok,
                                     bool check_nan, int& to_save, int save_every,
                                     T (&pmax)[4], T (&y_last)[8]) {
    T y_new[8], comp_new[8];
    bool fin = true;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        if constexpr (kCompensated<T>) {
            const T corrected = delta[q] - comp[q];
            y_new[q] = y[q] + corrected;
            comp_new[q] = (y_new[q] - y[q]) - corrected;
        } else {
            y_new[q] = y[q] + delta[q];
        }
        fin = fin && isfinite(y_new[q]);
    }
    if (!check_nan || (ok && fin)) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            y[q] = y_new[q];
            if constexpr (kCompensated<T>) comp[q] = comp_new[q];
        }
    } else {
        ok = false;
    }
    if (--to_save == 0) {
        to_save = save_every;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const T P = y[j] * y[j] + y[4 + j] * y[4 + j];
            pmax[j] = P > pmax[j] ? P : pmax[j];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) y_last[q] = y[q];
    }
}

template <typename T, int METHOD>
__global__ void __launch_bounds__(kThreads)
fwm4_rk_kernel(const T* __restrict__ coef, const T* __restrict__ y0, T* __restrict__ pmax_out,
               T* __restrict__ y_last_out, uint8_t* __restrict__ ok_out, int B, int n_steps,
               int save_every, int check_nan, T dz) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    const Coef<T> c = fwm4::load_coef(coef, B, b);
    const T half_dz = T(0.5) * dz;
    const T dz_over_6 = dz / T(6);

    T y[8], comp[8], y_last[8], pmax[4];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        y[q] = y0[q * B + b];
        comp[q] = T(0);
        y_last[q] = y[q];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) pmax[j] = y[j] * y[j] + y[4 + j] * y[4 + j];
    bool ok = true;
    const bool nan_check = check_nan != 0;
    int to_save = save_every;

    if (METHOD == kRK4) {
        for (int i = 0; i < n_steps; ++i) {
            T delta[8], k1[8];
            rk4(y, c, half_dz, dz, dz_over_6, delta, k1);
            keep(y, comp, delta, ok, nan_check, to_save, save_every, pmax, y_last);
        }
    } else {
        // f1, f2, f3: f at steps n-1, n-2, n-3
        T f1[8] = {}, f2[8] = {}, f3[8] = {};
        const int n_boot = n_steps < 3 ? n_steps : 3;
        for (int i = 0; i < n_boot; ++i) {
            T delta[8], k1[8];
            rk4(y, c, half_dz, dz, dz_over_6, delta, k1);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                f3[q] = f2[q];
                f2[q] = f1[q];
                f1[q] = k1[q];
            }
            keep(y, comp, delta, ok, nan_check, to_save, save_every, pmax, y_last);
        }
        const T w = dz / T(24);
        for (int i = n_boot; i < n_steps; ++i) {
            T f0[8], delta[8];
            rhs(y, c, f0);
#pragma unroll
            for (int q = 0; q < 8; ++q)
                delta[q] = w * (T(55) * f0[q] - T(59) * f1[q] + T(37) * f2[q] - T(9) * f3[q]);
            if (METHOD == kABM4) {
                T y_pred[8], fp[8];
#pragma unroll
                for (int q = 0; q < 8; ++q) y_pred[q] = y[q] + delta[q];
                rhs(y_pred, c, fp);
#pragma unroll
                for (int q = 0; q < 8; ++q)
                    delta[q] = w * (T(9) * fp[q] + T(19) * f0[q] - T(5) * f1[q] + f2[q]);
            }
            keep(y, comp, delta, ok, nan_check, to_save, save_every, pmax, y_last);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                f3[q] = f2[q];
                f2[q] = f1[q];
                f1[q] = f0[q];
            }
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) pmax_out[j * B + b] = pmax[j];
#pragma unroll
    for (int q = 0; q < 8; ++q) y_last_out[q * B + b] = y_last[q];
    ok_out[b] = ok ? 1 : 0;
}

template <typename T, int METHOD>
int launch(const void* coef, const void* y0, void* pmax, void* y_last, void* ok, int B,
           int n_steps, int save_every, int check_nan, double dz, void* stream) {
    const int blocks = (B + kThreads - 1) / kThreads;
    fwm4_rk_kernel<T, METHOD><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(coef), static_cast<const T*>(y0), static_cast<T*>(pmax),
        static_cast<T*>(y_last), static_cast<uint8_t*>(ok), B, n_steps, save_every,
        check_nan, static_cast<T>(dz));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FWM4_LAUNCHER(NAME, T, METHOD)                                                 \
    extern "C" int NAME(const void* coef, const void* y0, void* pmax, void* y_last,     \
                        void* ok, int B, int n_steps, int save_every, int check_nan,    \
                        double dz, void* stream) {                                      \
        return launch<T, METHOD>(coef, y0, pmax, y_last, ok, B, n_steps, save_every,    \
                                 check_nan, dz, stream);                                \
    }

FWM4_LAUNCHER(fwm4_rk4_f64, double, kRK4)
FWM4_LAUNCHER(fwm4_ab4_f64, double, kAB4)
FWM4_LAUNCHER(fwm4_abm4_f64, double, kABM4)
FWM4_LAUNCHER(fwm4_rk4_f32, float, kRK4)
FWM4_LAUNCHER(fwm4_ab4_f32, float, kAB4)
FWM4_LAUNCHER(fwm4_abm4_f32, float, kABM4)
