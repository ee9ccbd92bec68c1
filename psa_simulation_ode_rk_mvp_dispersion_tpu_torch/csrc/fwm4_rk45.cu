// Batched adaptive (Dormand-Prince 5(4)) integration of the 4-wave FWM
// system in the rotating (autonomous) frame, one CUDA thread per instance.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_adaptive.py::_kernel_body   (K3, the rk45 tier)
// with one template, fwm4_rk45_kernel<T>, T in {double, float}: float64
// serves x64/df32, float32 serves x32.
//
// What bounds it: FP64 (or FP32) arithmetic.  One attempted step is 6 RHS
// evaluations of 111 flop (the first stage carries over from the last
// accepted step: FSAL), the stage sums, the error estimate, the error norm
// and the controller, about 1,190 flop in all; the state, its RHS, the
// stages, the controller state (local z, dt, counters) and the running P_max
// live in registers for the whole integration.  Coefficients and y0 are read once and
// the outputs written once, so the step loop moves no memory.  Lanes of a
// warp take different numbers of steps and the warp runs until its slowest
// lane is done; the sweep's sorted wavelength grid keeps neighbouring lanes
// alike.  Known limits, left for later work: at B = 10^4 one thread per lane
// fills only ~79 blocks of 128 threads on the H100's 132 SMs, and nothing is
// done about divergence beyond the lane order.
//
// What it computes (the contract of ops/adaptive.py and of the TPU kernel it
// replaces; ops/cuda_adaptive.solve_batch_rk45_torch is the plain version and
// takes the same steps):
//   - n_chunks saved segments of length seg_len, then, if tail_len > 0, one
//     trailing unsaved span that feeds ok and the counters only;
//   - every segment in local z in [0, len], dt_min = 1e-12 * (len + 1); the
//     step proposal dt starts at dt0 and carries across segments; each step
//     is h = min(dt, len - z);
//   - a DP45 step with the stage sums in the tableau's order,
//     yi = y + (h*a_ij)*k_j; y5 is the seventh stage's input and the error
//     estimate accumulates (h*(b5_i - b4_i))*k_i in the order of i; k1 is
//     f(y0) for the first attempt and the accepted step's k7 = f(y5) after
//     (FSAL), across segments too;
//   - the error norm sqrt(mean_j (|err_j| / (atol + rtol*max(|y_j|,
//     |y5_j|)))^2) over the 4 complex components, 0/0 read as 0;
//   - accept when the step and its norm are finite and the norm <= 1; the
//     factor is clip(0.9 * pow(max(norm, 1e-16), -1/5), 0.2, 5), or 0.5 for a
//     non-finite step, and dt = max(dt * factor, dt_min);
//   - a rejected step with h <= dt_min clears ok; so does a segment not
//     finished within max_steps attempts; a failed lane keeps its last
//     accepted state and takes no further steps;
//   - after each saved segment P_max = max(P_max, |y|^2) (P_max starts from
//     |y0|^2); y_last is the state at the end of the last saved segment.
//
// Layout: structure of arrays, row k of a (rows, B) buffer at k*B.
//   coef (3, B): gamma, alpha, delta_beta;  y0 (8, B): re(A1..A4), im(A1..A4)
//   pmax (4, B), y_last (8, B) in the same order, ok (B,) uint8,
//   n_accepted, n_rejected (B,) int32.
//
// Rounding: the plain version (ops/rhs.rhs_yaman_autonomous and
// ops/adaptive.py) makes one torch operation of every product and sum here,
// in this order, and this file is compiled with -fmad=false, so kernel and
// plain version round alike and take the same steps.  In float32 the error
// estimate is mostly rounding noise, so any difference in rounding would
// flip accept/reject decisions and send the two down different steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (ops/_build.py); bound with ctypes
// through the extern "C" launchers at the end, each of which returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Dormand-Prince 5(4) tableau (ops/adaptive.py), in double; each use casts
// to T, as the plain version's Python floats are cast to the tensor's type.
constexpr double kA21 = 1.0 / 5.0;
constexpr double kA31 = 3.0 / 40.0, kA32 = 9.0 / 40.0;
constexpr double kA41 = 44.0 / 45.0, kA42 = -56.0 / 15.0, kA43 = 32.0 / 9.0;
constexpr double kA51 = 19372.0 / 6561.0, kA52 = -25360.0 / 2187.0, kA53 = 64448.0 / 6561.0,
                 kA54 = -212.0 / 729.0;
constexpr double kA61 = 9017.0 / 3168.0, kA62 = -355.0 / 33.0, kA63 = 46732.0 / 5247.0,
                 kA64 = 49.0 / 176.0, kA65 = -5103.0 / 18656.0;
constexpr double kA71 = 35.0 / 384.0, kA73 = 500.0 / 1113.0, kA74 = 125.0 / 192.0,
                 kA75 = -2187.0 / 6784.0, kA76 = 11.0 / 84.0;
// b5 - b4 (b5 is the seventh row of A, then 0)
constexpr double kE1 = 35.0 / 384.0 - 5179.0 / 57600.0;
constexpr double kE3 = 500.0 / 1113.0 - 7571.0 / 16695.0;
constexpr double kE4 = 125.0 / 192.0 - 393.0 / 640.0;
constexpr double kE5 = -2187.0 / 6784.0 - -92097.0 / 339200.0;
constexpr double kE6 = 11.0 / 84.0 - 187.0 / 2100.0;
constexpr double kE7 = 0.0 - 1.0 / 40.0;

template <typename T>
struct Coef {
    T gamma;
    T two_gamma;
    T neg_half_alpha;
    T neg_half_dbeta;  // pump detuning
};

// d = f(y); y[0..3] real parts, y[4..7] imaginary parts.  The same term
// order as csrc/fwm4_rk.cu and pallas_adaptive.py:94-133.
template <typename T>
__device__ __forceinline__ void rhs(const T (&y)[8], const Coef<T>& c, T (&d)[8]) {
    T P[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) P[j] = y[j] * y[j] + y[4 + j] * y[4 + j];
    const T tot = ((P[0] + P[1]) + P[2]) + P[3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const T gF = c.gamma * (T(2) * tot - P[j]);
        d[j] = c.neg_half_alpha * y[j] - gF * y[4 + j];
        d[4 + j] = c.neg_half_alpha * y[4 + j] + gF * y[j];
    }
    const T r1 = y[0], r2 = y[1], r3 = y[2], r4 = y[3];
    const T i1 = y[4], i2 = y[5], i3 = y[6], i4 = y[7];
    const T s34_re = r3 * r4 - i3 * i4, s34_im = r3 * i4 + i3 * r4;
    const T s12_re = r1 * r2 - i1 * i2, s12_im = r1 * i2 + i1 * r2;
    const T t_re[4] = {r2 * s34_re + i2 * s34_im, r1 * s34_re + i1 * s34_im,
                       r4 * s12_re + i4 * s12_im, r3 * s12_re + i3 * s12_im};
    const T t_im[4] = {r2 * s34_im - i2 * s34_re, r1 * s34_im - i1 * s34_re,
                       r4 * s12_im - i4 * s12_re, r3 * s12_im - i3 * s12_re};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        d[j] -= c.two_gamma * t_im[j];
        d[4 + j] += c.two_gamma * t_re[j];
    }
    d[0] -= c.neg_half_dbeta * i1;
    d[4] += c.neg_half_dbeta * r1;
    d[1] -= c.neg_half_dbeta * i2;
    d[5] += c.neg_half_dbeta * r2;
}

// acc += (h*a) * k, component-wise
template <typename T>
__device__ __forceinline__ void axpy(T (&acc)[8], T ha, const T (&k)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = acc[q] + ha * k[q];
}

// One Dormand-Prince step of size h from y, whose first stage k1 = f(y) is
// given: y5, the error estimate, and k7 = f(y5), the first stage of the step
// after an accepted one (FSAL), so an attempt evaluates the RHS six times.
// A stage vector lives only until its last use, which keeps at most five of
// them (40 values) live at once.
template <typename T>
__device__ __forceinline__ void dp45(const T (&y)[8], const T (&k1)[8], const Coef<T>& c, T h,
                                     T (&y5)[8], T (&err)[8], T (&k7)[8]) {
    T k2[8], k3[8], k4[8], k5[8], k6[8], yi[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) yi[q] = y[q];
    axpy(yi, h * T(kA21), k1);
    rhs(yi, c, k2);
#pragma unroll
    for (int q = 0; q < 8; ++q) yi[q] = y[q];
    axpy(yi, h * T(kA31), k1);
    axpy(yi, h * T(kA32), k2);
    rhs(yi, c, k3);
#pragma unroll
    for (int q = 0; q < 8; ++q) yi[q] = y[q];
    axpy(yi, h * T(kA41), k1);
    axpy(yi, h * T(kA42), k2);
    axpy(yi, h * T(kA43), k3);
    rhs(yi, c, k4);
#pragma unroll
    for (int q = 0; q < 8; ++q) yi[q] = y[q];
    axpy(yi, h * T(kA51), k1);
    axpy(yi, h * T(kA52), k2);
    axpy(yi, h * T(kA53), k3);
    axpy(yi, h * T(kA54), k4);
    rhs(yi, c, k5);
#pragma unroll
    for (int q = 0; q < 8; ++q) yi[q] = y[q];
    axpy(yi, h * T(kA61), k1);
    axpy(yi, h * T(kA62), k2);
    axpy(yi, h * T(kA63), k3);
    axpy(yi, h * T(kA64), k4);
    axpy(yi, h * T(kA65), k5);
    rhs(yi, c, k6);
    // the seventh stage's input is the 5th-order solution (b5 = a7)
#pragma unroll
    for (int q = 0; q < 8; ++q) y5[q] = y[q];
    axpy(y5, h * T(kA71), k1);
    axpy(y5, h * T(kA73), k3);
    axpy(y5, h * T(kA74), k4);
    axpy(y5, h * T(kA75), k5);
    axpy(y5, h * T(kA76), k6);
#pragma unroll
    for (int q = 0; q < 8; ++q) err[q] = T(0);
    axpy(err, h * T(kE1), k1);
    axpy(err, h * T(kE3), k3);
    axpy(err, h * T(kE4), k4);
    axpy(err, h * T(kE5), k5);
    axpy(err, h * T(kE6), k6);
    rhs(y5, c, k7);
    axpy(err, h * T(kE7), k7);
}

template <typename T>
struct Lane {
    T y[8];
    T k1[8];  // f(y): the next attempt's first stage
    T dt;
    bool ok;
    int n_acc;
    int n_rej;
};

// Advance one lane over a segment of length len in local z.
template <typename T>
__device__ __forceinline__ void advance(Lane<T>& s, const Coef<T>& c, double len, T rtol,
                                        T atol, int max_steps) {
    const T seg = T(len);
    const T dt_min = T(1e-12 * (len + 1.0));
    T z = T(0);
    for (int it = 0; it < max_steps && s.ok && z < seg; ++it) {
        const T h = fmin(s.dt, seg - z);
        T y5[8], err[8], k7[8];
        dp45(s.y, s.k1, c, h, y5, err, k7);
        T sum = T(0);
        bool fin = true;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const T p = s.y[j] * s.y[j] + s.y[4 + j] * s.y[4 + j];
            const T pn = y5[j] * y5[j] + y5[4 + j] * y5[4 + j];
            const T scale = atol + rtol * sqrt(fmax(p, pn));
            const T e = sqrt(err[j] * err[j] + err[4 + j] * err[4 + j]);
            const T r = scale > T(0) ? e / scale : T(0);
            sum = j == 0 ? r * r : sum + r * r;
            fin = fin && isfinite(y5[j]) && isfinite(y5[4 + j]);
        }
        const T enorm = sqrt(sum / T(4));
        const bool finite = fin && isfinite(enorm);
        const bool accept = finite && enorm <= T(1);
        const T factor = finite
            ? fmin(fmax(T(0.9) * pow(fmax(enorm, T(1e-16)), T(-1.0 / 5.0)), T(0.2)), T(5))
            : T(0.5);
        s.dt = fmax(s.dt * factor, dt_min);
        if (accept) {
            z = z + h;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                s.y[q] = y5[q];
                s.k1[q] = k7[q];
            }
            ++s.n_acc;
        } else {
            ++s.n_rej;
            if (h <= dt_min) s.ok = false;
        }
    }
    if (!(z >= seg)) s.ok = false;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwm4_rk45_kernel(const T* __restrict__ coef, const T* __restrict__ y0, T* __restrict__ pmax_out,
                 T* __restrict__ y_last_out, uint8_t* __restrict__ ok_out,
                 int32_t* __restrict__ n_acc_out, int32_t* __restrict__ n_rej_out, int B,
                 int n_chunks, double seg_len, double tail_len, double dt0, T rtol, T atol,
                 int max_steps) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    Coef<T> c;
    c.gamma = coef[b];
    c.two_gamma = T(2) * c.gamma;
    c.neg_half_alpha = T(-0.5) * coef[B + b];
    c.neg_half_dbeta = T(-0.5) * coef[2 * B + b];

    Lane<T> s;
#pragma unroll
    for (int q = 0; q < 8; ++q) s.y[q] = y0[q * B + b];
    rhs(s.y, c, s.k1);
    s.dt = T(dt0);
    s.ok = true;
    s.n_acc = 0;
    s.n_rej = 0;
    T pmax[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) pmax[j] = s.y[j] * s.y[j] + s.y[4 + j] * s.y[4 + j];

    for (int i = 0; i < n_chunks; ++i) {
        advance(s, c, seg_len, rtol, atol, max_steps);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const T P = s.y[j] * s.y[j] + s.y[4 + j] * s.y[4 + j];
            pmax[j] = P > pmax[j] ? P : pmax[j];
        }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) y_last_out[q * B + b] = s.y[q];
    if (tail_len > 0.0) advance(s, c, tail_len, rtol, atol, max_steps);

#pragma unroll
    for (int j = 0; j < 4; ++j) pmax_out[j * B + b] = pmax[j];
    ok_out[b] = s.ok ? 1 : 0;
    n_acc_out[b] = s.n_acc;
    n_rej_out[b] = s.n_rej;
}

template <typename T>
int launch(const void* coef, const void* y0, void* pmax, void* y_last, void* ok, void* n_acc,
           void* n_rej, int B, int n_chunks, double seg_len, double tail_len, double dt0,
           double rtol, double atol, int max_steps, void* stream) {
    const int blocks = (B + kThreads - 1) / kThreads;
    fwm4_rk45_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(coef), static_cast<const T*>(y0), static_cast<T*>(pmax),
        static_cast<T*>(y_last), static_cast<uint8_t*>(ok), static_cast<int32_t*>(n_acc),
        static_cast<int32_t*>(n_rej), B, n_chunks, seg_len, tail_len, dt0, static_cast<T>(rtol),
        static_cast<T>(atol), max_steps);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FWM4_RK45_LAUNCHER(NAME, T)                                                         \
    extern "C" int NAME(const void* coef, const void* y0, void* pmax, void* y_last, void* ok, \
                        void* n_acc, void* n_rej, int B, int n_chunks, double seg_len,        \
                        double tail_len, double dt0, double rtol, double atol,                \
                        int max_steps, void* stream) {                                        \
        return launch<T>(coef, y0, pmax, y_last, ok, n_acc, n_rej, B, n_chunks, seg_len,     \
                         tail_len, dt0, rtol, atol, max_steps, stream);                       \
    }

FWM4_RK45_LAUNCHER(fwm4_rk45_f64, double)
FWM4_RK45_LAUNCHER(fwm4_rk45_f32, float)
