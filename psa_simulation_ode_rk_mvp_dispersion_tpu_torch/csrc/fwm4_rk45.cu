// Batched adaptive (Dormand-Prince 5(4)) integration of the 4-wave FWM
// system in the rotating (autonomous) frame, a lane (one instance) over a
// group of G threads.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_adaptive.py::_kernel_body   (K3, the rk45 tier)
// with one template, fwm4_rk45_kernel<T, G>, T in {double, float}: float64
// serves x64/df32, float32 serves x32.
//
// Design: one attempted step is 6 RHS evaluations of 111 flop (the first
// stage carries over from the last accepted step: FSAL), the stage sums, the
// error estimate, the error norm and the controller, about 1,190 flop in
// all.  A lane's attempts are serial, and at the main path's 10^4 lanes
// every block is resident from the start, so the kernel lasts as long as its
// slowest lane: on the bench grid the lanes near 1,650 nm take 3x (fp64) to
// 4x (fp32) the mean attempts, on warp schedulers of their own.  The time to
// cut is that lane's attempt, a chain of dependent operations.  Below
// kLanesPerSM lanes an SM a lane is therefore spread over G = 4 threads of
// one warp (csrc/fwm4_group.cuh): thread j owns wave j -- its parts of the
// state, the stages k1..k7, y5, the error estimate and P_max, in registers
// for the whole integration -- computes its wave's derivatives, stage sums
// and error terms, and takes the RHS couplings and the four terms of the
// error norm from the group through __shfl_sync.  Every thread of the group
// evaluates the norm, the step factor, the accept decision and the counters
// itself from the same values, so the group takes its steps as one.  From
// kLanesPerSM lanes an SM on, the card's issue rate bounds the kernel, and a
// lane runs on one thread (G = 1), free to diverge from its warp's other
// lanes within a segment.  What bounds it at 10^4 lanes: the chain
// of one attempt in the slowest lane -- 6 RHS, each with two rounds of
// shuffles, and the controller's sqrt, division and pow, which a group does
// not shorten.  Coefficients and y0 are read once and the outputs written
// once, so the step loop moves no memory.
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
// in this order.  The float32 instantiation forms every product with
// __fmul_rn (fwm4::Order::kExact), which nvcc never contracts, so it rounds as
// the plain version and takes the same steps: its error estimate is mostly
// rounding noise, and any difference in rounding would flip accept/reject
// decisions.  The float64 instantiation lets nvcc contract products and
// sums into fused multiply-adds; its error estimate is far above rounding,
// and it takes the plain version's steps all the same (chip_fma_ab.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" launchers at the end, each of which returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fwm4_group.cuh"

namespace {

using fwm4::Coef;
using fwm4::Group;

constexpr int kThreads = 128;

// The plain version's order in both types; float32's products must not
// contract (see Rounding above).
template <typename T>
constexpr fwm4::Order kOrder =
    std::is_same<T, float>::value ? fwm4::Order::kExact : fwm4::Order::kPlain;

template <typename T>
__device__ __forceinline__ T mul(T a, T b) {
    return fwm4::mul<kOrder<T>>(a, b);
}

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

template <int G, typename T>
__device__ __forceinline__ void rhs(const Group<G>& grp, const T (&y)[8 / G], const Coef<T>& c,
                                    T (&d)[8 / G]) {
    fwm4::rhs<kOrder<T>>(grp, y, c, d);
}

// acc += (h*a) * k, component-wise
template <int Q, typename T>
__device__ __forceinline__ void axpy(T (&acc)[Q], T ha, const T (&k)[Q]) {
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = acc[q] + mul(ha, k[q]);
}

// One Dormand-Prince step of size h from y, whose first stage k1 = f(y) is
// given: y5, the error estimate, and k7 = f(y5), the first stage of the step
// after an accepted one (FSAL), so an attempt evaluates the RHS six times.
// A stage vector lives only until its last use, which keeps at most five of
// them live at once.  Each array holds the thread's own components.
template <int G, typename T>
__device__ __forceinline__ void dp45(const Group<G>& grp, const T (&y)[8 / G],
                                     const T (&k1)[8 / G], const Coef<T>& c, T h,
                                     T (&y5)[8 / G], T (&err)[8 / G], T (&k7)[8 / G]) {
    constexpr int Q = 8 / G;
    T k2[Q], k3[Q], k4[Q], k5[Q], k6[Q], yi[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) yi[q] = y[q];
    axpy(yi, mul(h, T(kA21)), k1);
    rhs(grp, yi, c, k2);
#pragma unroll
    for (int q = 0; q < Q; ++q) yi[q] = y[q];
    axpy(yi, mul(h, T(kA31)), k1);
    axpy(yi, mul(h, T(kA32)), k2);
    rhs(grp, yi, c, k3);
#pragma unroll
    for (int q = 0; q < Q; ++q) yi[q] = y[q];
    axpy(yi, mul(h, T(kA41)), k1);
    axpy(yi, mul(h, T(kA42)), k2);
    axpy(yi, mul(h, T(kA43)), k3);
    rhs(grp, yi, c, k4);
#pragma unroll
    for (int q = 0; q < Q; ++q) yi[q] = y[q];
    axpy(yi, mul(h, T(kA51)), k1);
    axpy(yi, mul(h, T(kA52)), k2);
    axpy(yi, mul(h, T(kA53)), k3);
    axpy(yi, mul(h, T(kA54)), k4);
    rhs(grp, yi, c, k5);
#pragma unroll
    for (int q = 0; q < Q; ++q) yi[q] = y[q];
    axpy(yi, mul(h, T(kA61)), k1);
    axpy(yi, mul(h, T(kA62)), k2);
    axpy(yi, mul(h, T(kA63)), k3);
    axpy(yi, mul(h, T(kA64)), k4);
    axpy(yi, mul(h, T(kA65)), k5);
    rhs(grp, yi, c, k6);
    // the seventh stage's input is the 5th-order solution (b5 = a7)
#pragma unroll
    for (int q = 0; q < Q; ++q) y5[q] = y[q];
    axpy(y5, mul(h, T(kA71)), k1);
    axpy(y5, mul(h, T(kA73)), k3);
    axpy(y5, mul(h, T(kA74)), k4);
    axpy(y5, mul(h, T(kA75)), k5);
    axpy(y5, mul(h, T(kA76)), k6);
#pragma unroll
    for (int q = 0; q < Q; ++q) err[q] = T(0);
    axpy(err, mul(h, T(kE1)), k1);
    axpy(err, mul(h, T(kE3)), k3);
    axpy(err, mul(h, T(kE4)), k4);
    axpy(err, mul(h, T(kE5)), k5);
    axpy(err, mul(h, T(kE6)), k6);
    rhs(grp, y5, c, k7);
    axpy(err, mul(h, T(kE7)), k7);
}

// One attempted step of size h from y (first stage k1): the 5th-order
// solution y5, its RHS k7, and the controller's verdict -- accept, and the
// step factor.  Every thread of the group evaluates the norm, the factor and
// the verdict itself, from the same gathered values, so the group takes each
// decision as one.
template <int G, typename T>
__device__ __forceinline__ void attempt(const Group<G>& grp, const T (&y)[8 / G],
                                        const T (&k1)[8 / G], const Coef<T>& c, T h, T rtol,
                                        T atol, T (&y5)[8 / G], T (&k7)[8 / G], bool& accept,
                                        T& factor) {
    constexpr int W = 4 / G, Q = 8 / G;
    T err[Q];
    dp45(grp, y, k1, c, h, y5, err, k7);
    // the norm's terms (|err_j| / scale_j)^2 of the owned waves
    T rr[W];
    bool fin = true;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        const T p = mul(y[w], y[w]) + mul(y[W + w], y[W + w]);
        const T pn = mul(y5[w], y5[w]) + mul(y5[W + w], y5[W + w]);
        const T scale = atol + mul(rtol, sqrt(fmax(p, pn)));
        const T e = sqrt(mul(err[w], err[w]) + mul(err[W + w], err[W + w]));
        const T r = scale > T(0) ? e / scale : T(0);
        rr[w] = mul(r, r);
        fin = fin && isfinite(y5[w]) && isfinite(y5[W + w]);
    }
    // summed in wave order, j = 0..3, in every thread of the group
    T sum = grp.get(rr[0], 0);
#pragma unroll
    for (int j = 1; j < 4; ++j) sum = sum + grp.get(rr[j % W], j / W);
    const T enorm = sqrt(sum / T(4));
    const bool finite = grp.all(fin) && isfinite(enorm);
    accept = finite && enorm <= T(1);
    factor = finite
        ? fmin(fmax(mul(T(0.9), pow(fmax(enorm, T(1e-16)), T(-1.0 / 5.0))), T(0.2)), T(5))
        : T(0.5);
}

// A lane's integration state, in each thread of its group.
template <int G, typename T>
struct Lane {
    T y[8 / G];
    T k1[8 / G];  // f(y): the next attempt's first stage
    T dt;
    bool ok;
    int n_acc;
    int n_rej;
};

// Advance a lane over a segment of length len in local z.  A lane on one
// thread runs while it is live, its warp's threads diverging freely; a
// group's shuffles name the whole warp, so a group runs while any lane of
// its warp is live, and a lane that is not computes along and commits
// nothing.  Either way the warp's threads meet again at the segment's end.
template <int G, typename T>
__device__ __forceinline__ void advance(const Group<G>& grp, Lane<G, T>& s, const Coef<T>& c,
                                        double len, T rtol, T atol, int max_steps) {
    constexpr int Q = 8 / G;
    const T seg = T(len);
    const T dt_min = T(1e-12 * (len + 1.0));
    T z = T(0);
    for (int it = 0;; ++it) {
        const bool live = it < max_steps && s.ok && z < seg;
        if constexpr (G == 1) {
            if (!live) break;
        } else {
            if (!__any_sync(fwm4::kFullMask, live)) break;
        }
        const T h = fmin(s.dt, seg - z);
        T y5[Q], k7[Q], factor;
        bool accept;
        attempt(grp, s.y, s.k1, c, h, rtol, atol, y5, k7, accept, factor);
        if (live) {
            s.dt = fmax(mul(s.dt, factor), dt_min);
            if (accept) {
                z = z + h;
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    s.y[q] = y5[q];
                    s.k1[q] = k7[q];
                }
                ++s.n_acc;
            } else {
                ++s.n_rej;
                if (h <= dt_min) s.ok = false;
            }
        }
    }
    if (!(z >= seg)) s.ok = false;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
fwm4_rk45_kernel(const T* __restrict__ coef, const T* __restrict__ y0, T* __restrict__ pmax_out,
                 T* __restrict__ y_last_out, uint8_t* __restrict__ ok_out,
                 int32_t* __restrict__ n_acc_out, int32_t* __restrict__ n_rej_out, int B,
                 int n_chunks, double seg_len, double tail_len, double dt0, T rtol, T atol,
                 int max_steps) {
    constexpr int W = 4 / G;
    const int b = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / G);
    if (b >= B) return;  // the whole group: blockDim is a multiple of G
    const Group<G> grp;
    const int j0 = grp.g * W;  // the first wave this thread owns

    const Coef<T> c = fwm4::load_coef(coef, B, b);
    Lane<G, T> s;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        s.y[w] = y0[(j0 + w) * B + b];
        s.y[W + w] = y0[(4 + j0 + w) * B + b];
    }
    rhs(grp, s.y, c, s.k1);
    s.dt = T(dt0);
    s.ok = true;
    s.n_acc = 0;
    s.n_rej = 0;
    T pmax[W];
    fwm4::powers<kOrder<T>, G>(s.y, pmax);

    for (int i = 0; i < n_chunks; ++i) {
        advance(grp, s, c, seg_len, rtol, atol, max_steps);
        T P[W];
        fwm4::powers<kOrder<T>, G>(s.y, P);
#pragma unroll
        for (int w = 0; w < W; ++w) pmax[w] = P[w] > pmax[w] ? P[w] : pmax[w];
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
        y_last_out[(j0 + w) * B + b] = s.y[w];
        y_last_out[(4 + j0 + w) * B + b] = s.y[W + w];
    }
    if (tail_len > 0.0) advance(grp, s, c, tail_len, rtol, atol, max_steps);

#pragma unroll
    for (int w = 0; w < W; ++w) pmax_out[(j0 + w) * B + b] = pmax[w];
    if (grp.g == 0) {
        ok_out[b] = s.ok ? 1 : 0;
        n_acc_out[b] = s.n_acc;
        n_rej_out[b] = s.n_rej;
    }
}

// Threads a lane for a batch of B lanes on the current card: 4 below
// kLanesPerSM lanes an SM, where the kernel lasts as long as its slowest
// lane's chain of attempts, 1 from there on, where the card's issue rate
// bounds it and a group's shuffles and repeated work cost more than they
// save (chip_fwm4_groups.py; PERF.md).
constexpr int kLanesPerSM = 256;

int group_size(int B) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return B >= kLanesPerSM * sms ? 1 : 4;
}

template <typename T, int G>
void launch_group(const void* coef, const void* y0, void* pmax, void* y_last, void* ok,
                  void* n_acc, void* n_rej, int B, int n_chunks, double seg_len,
                  double tail_len, double dt0, double rtol, double atol, int max_steps,
                  void* stream) {
    const int blocks = static_cast<int>((static_cast<long long>(B) * G + kThreads - 1) / kThreads);
    fwm4_rk45_kernel<T, G><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(coef), static_cast<const T*>(y0), static_cast<T*>(pmax),
        static_cast<T*>(y_last), static_cast<uint8_t*>(ok), static_cast<int32_t*>(n_acc),
        static_cast<int32_t*>(n_rej), B, n_chunks, seg_len, tail_len, dt0, static_cast<T>(rtol),
        static_cast<T>(atol), max_steps);
}

template <typename T>
int launch(const void* coef, const void* y0, void* pmax, void* y_last, void* ok, void* n_acc,
           void* n_rej, int B, int n_chunks, double seg_len, double tail_len, double dt0,
           double rtol, double atol, int max_steps, void* stream) {
    if (group_size(B) == 1) {
        launch_group<T, 1>(coef, y0, pmax, y_last, ok, n_acc, n_rej, B, n_chunks, seg_len,
                           tail_len, dt0, rtol, atol, max_steps, stream);
    } else {
        launch_group<T, 4>(coef, y0, pmax, y_last, ok, n_acc, n_rej, B, n_chunks, seg_len,
                           tail_len, dt0, rtol, atol, max_steps, stream);
    }
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

// The threads a lane the launchers above give a batch of B lanes on the
// current card.
extern "C" int fwm4_rk45_group(int B) { return group_size(B); }
