// Batched adaptive (Dormand-Prince 5(4)) integration of the N-wave
// cascaded-FWM comb, one CUDA thread block per comb instance.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_comb_adaptive.py::_kernel_body   (K5, the comb rk45 kernel)
// with one template, comb_rk45_kernel<T, LPT>, T in {double, float}: float64
// serves x64/df32, float32 serves x32; LPT the lines a thread.
//
// What bounds it: the latency of the transform passes, as in K4.  An
// attempted step is 6 RHS evaluations (the first stage is the last accepted
// step's seventh: FSAL), each the cubic sum through two L-point FFTs of
// csrc/comb_common.cuh's comb::Coupling (the comb's own radix-4 passes on a
// float64 table, every butterfly in double), plus O(N) stage sums, error
// estimate and norm.  At N = 64 (L = 128) a comb is one warp of 32 threads,
// 2 lines a thread, with __syncwarp between passes: no block barrier in the
// attempt.  A thread holds its lines' state, stage input and error
// estimate in registers for the whole integration; the seven stages live
// in the comb's shared memory, each thread's own slots (stage s of line
// slot i at k[s][i nt + tid]), so that they cost no barrier and the
// registers stay near K4's; the transforms' 3 L complex values sit beside
// them.  Inputs are read once and outputs written once.  The controller is
// uniform within a block (one comb), so unlike the 4-wave kernel K3 no
// instance waits on another instance's steps: each block runs exactly its
// comb's attempts.  Wider combs (L > 128) take more threads, up to 256 a
// comb, then more lines a thread (LPT 4 at L = 2,048, and in fp32 8 at
// 4,096), as K4.
//
// What it computes (the contract of ops/adaptive.py over a (B, N) state,
// which ops/cuda_comb_adaptive.solve_comb_batch_rk45_torch runs; this is
// the port's controller, the same as K3's, not the JAX kernel's):
//   - n_chunks saved segments of length seg_len, then, if tail_len > 0, one
//     trailing unsaved span that feeds ok and the counters only;
//   - every segment in local z in [0, len], dt_min = 1e-12 * (len + 1); dt
//     starts at dt0 (0.1 x the first span) and carries across segments;
//     each step is h = min(dt, len - z); at most max_steps attempts per
//     segment;
//   - stage sums in the tableau's order, yi = y + (h*a_ij)*k_j; y5 is the
//     seventh stage's input and the error estimate accumulates
//     (h*(b5_i - b4_i))*k_i in the order of i; k1 carries over (FSAL);
//   - the error norm sqrt((sum_j r_j^2) / N), r_j = |err_j| / (atol + rtol *
//     max(|y_j|, |y5_j|)) and 0/0 read as 0, the sum taken in line order
//     (by every thread of the comb, from the lines' r_j^2 in shared memory),
//     as the plain version sums it;
//   - accept when the step and its norm are finite and the norm <= 1; the
//     factor is clip(0.9 * pow(max(norm, 1e-16), -1/5), 0.2, 5), or 0.5 for a
//     non-finite step, and dt = max(dt * factor, dt_min);
//   - a rejected step with h <= dt_min clears ok, and so does a segment not
//     finished within max_steps; a failed comb keeps its last accepted state;
//   - after each saved segment P_max = max(P_max, |A|^2) (from |A0|^2);
//     y_last is the state at the end of the last saved segment.
//
// Global layout (row-major, one row per instance): gamma, alpha (B,); beta
// (B, N); tw (L, 2) = (cos, sin)(2 pi k / L) in float64, L = max(128,
// 2^ceil(log2(2N-1))); y0 (B, 2N) = [Re A | Im A]; outputs pmax (B, N),
// y_last (B, 2N), ok (B,) uint8, n_accepted, n_rejected (B,) int32.
//
// Rounding: compiled with -fmad=false (ops/_build.py), so that every product
// and sum rounds as the plain version's torch operations, whose cubic sum
// (ops/cuda_comb.kernel_polarization) has this kernel's passes and rounding
// points and whose error norm takes its mean by a true division, as this
// one does (ops/adaptive.py).  That matters most in float32, where the
// error estimate is mostly rounding noise and a blowing-up comb fails at
// dt_min on the last bit of each rounding: the two take the same steps on
// every comb (tests/test_torch_kernel.py on the card, and the host build in
// tests/test_torch_comb_host.py; chip_comb_rk45_probe.py checks the step
// factor's pow and the mean against torch's).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (ops/_build.py); bound with ctypes
// through the extern "C" functions at the end; the launchers return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "comb_common.cuh"

namespace {

using comb::Coupling;
using Cd = ssfm::Cx<double>;

// buffers of L complex values a comb keeps in shared memory for the
// transforms, and stages of L/2 (one a line slot of each thread)
constexpr int kBuffers = 3;
constexpr int kStages = 7;

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

// One comb's integration: its coupling, its lines' state in registers and
// its stages in shared memory.  The controller values are the same in every
// thread of the comb.
template <typename T, int LPT>
struct Comb {
    using Cx = ssfm::Cx<T>;
    Coupling<T, LPT> c;
    Cx* k[kStages];  // shared: stage s of slot i at k[s][i nt + tid]
    T* r2;           // shared (n,): the lines' r_j^2
    Cx y[LPT], x[LPT], err[LPT], d[LPT];  // state, stage input (y5 last), error, f(x)
    T pmax[LPT];
    T dt;
    bool ok;
    int n_acc, n_rej;

    __device__ __forceinline__ Cx& ks(int s, int i) const { return k[s][i * c.f.nt + c.f.tid]; }

    // a + w v for a complex a and v, the plain version's order per component.
    static __device__ __forceinline__ Cx axpy(const Cx& a, T w, const Cx& v) {
        return Cx{a.re + w * v.re, a.im + w * v.im};
    }

    // Stage s = f(x).
    __device__ __forceinline__ void stage(int s) {
        c.rhs(x, d);
#pragma unroll
        for (int i = 0; i < LPT; ++i) ks(s, i) = d[i];
    }

    // One Dormand-Prince attempt of size h from y with first stage k[0]: x =
    // y5, err, and k[6] = f(y5).  Sums in the tableau's order.
    __device__ __forceinline__ void dp45(T h) {
        // each coefficient h * a_ij is formed where it is used, so that it
        // is not held in a register across the RHS evaluations
#pragma unroll
        for (int i = 0; i < LPT; ++i) x[i] = axpy(y[i], h * T(kA21), ks(0, i));
        stage(1);
#pragma unroll
        for (int i = 0; i < LPT; ++i)
            x[i] = axpy(axpy(y[i], h * T(kA31), ks(0, i)), h * T(kA32), ks(1, i));
        stage(2);
#pragma unroll
        for (int i = 0; i < LPT; ++i)
            x[i] = axpy(axpy(axpy(y[i], h * T(kA41), ks(0, i)), h * T(kA42), ks(1, i)),
                        h * T(kA43), ks(2, i));
        stage(3);
#pragma unroll
        for (int i = 0; i < LPT; ++i)
            x[i] = axpy(axpy(axpy(axpy(y[i], h * T(kA51), ks(0, i)), h * T(kA52), ks(1, i)),
                             h * T(kA53), ks(2, i)),
                        h * T(kA54), ks(3, i));
        stage(4);
#pragma unroll
        for (int i = 0; i < LPT; ++i)
            x[i] = axpy(axpy(axpy(axpy(axpy(y[i], h * T(kA61), ks(0, i)), h * T(kA62), ks(1, i)),
                                  h * T(kA63), ks(2, i)),
                             h * T(kA64), ks(3, i)),
                        h * T(kA65), ks(4, i));
        stage(5);
        // the seventh stage's input is the 5th-order solution (b5 = a7)
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            x[i] = axpy(axpy(axpy(axpy(axpy(y[i], h * T(kA71), ks(0, i)), h * T(kA73), ks(2, i)),
                                  h * T(kA74), ks(3, i)),
                             h * T(kA75), ks(4, i)),
                        h * T(kA76), ks(5, i));
            err[i] = axpy(axpy(axpy(axpy(axpy(Cx{T(0), T(0)}, h * T(kE1), ks(0, i)), h * T(kE3),
                                         ks(2, i)),
                                    h * T(kE4), ks(3, i)),
                               h * T(kE5), ks(4, i)),
                          h * T(kE6), ks(5, i));
        }
        stage(6);
#pragma unroll
        for (int i = 0; i < LPT; ++i) err[i] = axpy(err[i], h * T(kE7), d[i]);
    }

    // Advance the comb over a segment of length len in local z.
    __device__ __forceinline__ void advance(double len, T rtol, T atol, int max_steps) {
        const int n = c.n;
        const T seg = T(len);
        const T dt_min = T(1e-12 * (len + 1.0));
        T z = T(0);
        for (int it = 0; it < max_steps && ok && z < seg; ++it) {
            const T h = fmin(dt, seg - z);
            dp45(h);
            int fin = 1;
#pragma unroll
            for (int i = 0; i < LPT; ++i) {
                const int j = c.line(i);
                if (j < n) {
                    const T p = y[i].re * y[i].re + y[i].im * y[i].im;
                    const T pn = x[i].re * x[i].re + x[i].im * x[i].im;
                    const T scale = atol + rtol * sqrt(fmax(p, pn));
                    const T e = sqrt(err[i].re * err[i].re + err[i].im * err[i].im);
                    const T r = scale > T(0) ? e / scale : T(0);
                    r2[j] = r * r;
                    fin &= (isfinite(x[i].re) && isfinite(x[i].im)) ? 1 : 0;
                }
            }
            if (c.f.nt == 32) __syncwarp();  // every line's r_j^2 (a block's AND is a barrier)
            const bool all_finite = c.all(fin != 0);
            T sum = r2[0];
            for (int j = 1; j < n; ++j) sum = sum + r2[j];
            const T enorm = sqrt(sum / T(n));
            const bool finite = all_finite && isfinite(enorm);
            const bool accept = finite && enorm <= T(1);
            const T factor = finite
                ? fmin(fmax(T(0.9) * pow(fmax(enorm, T(1e-16)), T(-1.0 / 5.0)), T(0.2)), T(5))
                : T(0.5);
            dt = fmax(dt * factor, dt_min);
            if (accept) {
                z = z + h;
#pragma unroll
                for (int i = 0; i < LPT; ++i) y[i] = x[i];
                Cx* t = k[0];
                k[0] = k[6];
                k[6] = t;
                ++n_acc;
            } else {
                ++n_rej;
                if (h <= dt_min) ok = false;
            }
        }
        if (!(z >= seg)) ok = false;
    }
};

template <typename T, int LPT>
__global__ void __launch_bounds__(comb::kMaxThreads)
comb_rk45_kernel(const T* __restrict__ gamma, const T* __restrict__ alpha,
                 const T* __restrict__ beta, const Cd* __restrict__ tw, const T* __restrict__ y0,
                 T* __restrict__ pmax_out, T* __restrict__ y_last_out,
                 uint8_t* __restrict__ ok_out, int32_t* __restrict__ n_acc_out,
                 int32_t* __restrict__ n_rej_out, int n, int L, int n_chunks, double seg_len,
                 double tail_len, double dt0, T rtol, T atol, int max_steps) {
    extern __shared__ __align__(16) unsigned char smem[];
    using Cx = ssfm::Cx<T>;
    const int b = blockIdx.x, n2 = 2 * n;
    Comb<T, LPT> s;
    s.c.f = ssfm::plan(tw, L, 1, threadIdx.x, blockDim.x);
    Cx* buf = reinterpret_cast<Cx*>(smem);
    s.c.b0 = buf;
    s.c.b1 = buf + L;
    s.c.b2 = buf + 2 * L;
#pragma unroll
    for (int q = 0; q < kStages; ++q) s.k[q] = buf + kBuffers * L + q * (L / 2);
    s.r2 = reinterpret_cast<T*>(buf + kBuffers * L + kStages * (L / 2));
    s.c.n = n;
    s.c.gamma = gamma[b];
    s.c.nha = T(-0.5) * alpha[b];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
        const int j = s.c.line(i);
        const bool in = j < n;
        s.c.beta[i] = in ? beta[static_cast<size_t>(b) * n + j] : T(0);
        s.y[i] = in ? Cx{y0[static_cast<size_t>(b) * n2 + j], y0[static_cast<size_t>(b) * n2 + n + j]}
                    : Cx{T(0), T(0)};
        s.pmax[i] = s.y[i].re * s.y[i].re + s.y[i].im * s.y[i].im;
    }
#pragma unroll
    for (int i = 0; i < LPT; ++i) s.x[i] = s.y[i];
    s.stage(0);
    s.dt = T(dt0);
    s.ok = true;
    s.n_acc = 0;
    s.n_rej = 0;

    for (int c = 0; c < n_chunks; ++c) {
        s.advance(seg_len, rtol, atol, max_steps);
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            const T P = s.y[i].re * s.y[i].re + s.y[i].im * s.y[i].im;
            s.pmax[i] = P > s.pmax[i] ? P : s.pmax[i];
        }
    }
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
        const int j = s.c.line(i);
        if (j < n) {
            y_last_out[static_cast<size_t>(b) * n2 + j] = s.y[i].re;
            y_last_out[static_cast<size_t>(b) * n2 + n + j] = s.y[i].im;
            pmax_out[static_cast<size_t>(b) * n + j] = s.pmax[i];
        }
    }
    if (tail_len > 0.0) s.advance(tail_len, rtol, atol, max_steps);
    if (threadIdx.x == 0) {
        ok_out[b] = s.ok ? 1 : 0;
        n_acc_out[b] = s.n_acc;
        n_rej_out[b] = s.n_rej;
    }
}

size_t shared_bytes(int n, int L, size_t elem) {
    return 2 * elem * (kBuffers * static_cast<size_t>(L) + kStages * static_cast<size_t>(L / 2))
           + elem * static_cast<size_t>(n);
}

// Whether the kernel takes L: a power of two from 128 to 4,096 (LPT <= 8).
bool takes(int n, int L) {
    return L >= 128 && L <= 4096 && (L & (L - 1)) == 0 && 2 * n - 1 <= L;
}

template <typename T, int LPT>
int launch_lines(const void* gamma, const void* alpha, const void* beta, const void* tw,
                 const void* y0, void* pmax, void* y_last, void* ok, void* n_acc, void* n_rej,
                 int B, int n, int L, int n_chunks, double seg_len, double tail_len, double dt0,
                 double rtol, double atol, int max_steps, void* stream) {
    const size_t smem = shared_bytes(n, L, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(comb_rk45_kernel<T, LPT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    comb_rk45_kernel<T, LPT>
        <<<B, comb::coupling_threads(L), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(gamma), static_cast<const T*>(alpha), static_cast<const T*>(beta),
        static_cast<const Cd*>(tw), static_cast<const T*>(y0), static_cast<T*>(pmax),
        static_cast<T*>(y_last), static_cast<uint8_t*>(ok), static_cast<int32_t*>(n_acc),
        static_cast<int32_t*>(n_rej), n, L, n_chunks, seg_len, tail_len, dt0,
        static_cast<T>(rtol), static_cast<T>(atol), max_steps);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* gamma, const void* alpha, const void* beta, const void* tw,
           const void* y0, void* pmax, void* y_last, void* ok, void* n_acc, void* n_rej, int B,
           int n, int L, int n_chunks, double seg_len, double tail_len, double dt0, double rtol,
           double atol, int max_steps, void* stream) {
    if (!takes(n, L)) return static_cast<int>(cudaErrorInvalidValue);
#define COMB_RK45_ARGS                                                                          \
    gamma, alpha, beta, tw, y0, pmax, y_last, ok, n_acc, n_rej, B, n, L, n_chunks, seg_len,     \
        tail_len, dt0, rtol, atol, max_steps, stream
    switch (comb::coupling_lines(L)) {
        case 2:
            return launch_lines<T, 2>(COMB_RK45_ARGS);
        case 4:
            return launch_lines<T, 4>(COMB_RK45_ARGS);
        default:
            // 8 lines a thread is L = 4,096, whose fp64 block does not fit
            // in shared memory (the wrapper refuses it first): not built
            if constexpr (sizeof(T) == 8)
                return static_cast<int>(cudaErrorInvalidValue);
            else
                return launch_lines<T, 8>(COMB_RK45_ARGS);
    }
#undef COMB_RK45_ARGS
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" int comb_rk45_shared_bytes(int n, int L, int elem) {
    return static_cast<int>(shared_bytes(n, L, static_cast<size_t>(elem)));
}

#define COMB_RK45_LAUNCHER(NAME, T)                                                             \
    extern "C" int NAME(const void* gamma, const void* alpha, const void* beta, const void* tw, \
                        const void* y0, void* pmax, void* y_last, void* ok, void* n_acc,        \
                        void* n_rej, int B, int n, int L, int n_chunks, double seg_len,         \
                        double tail_len, double dt0, double rtol, double atol, int max_steps,   \
                        void* stream) {                                                         \
        return launch<T>(gamma, alpha, beta, tw, y0, pmax, y_last, ok, n_acc, n_rej, B, n, L,  \
                         n_chunks, seg_len, tail_len, dt0, rtol, atol, max_steps, stream);     \
    }

COMB_RK45_LAUNCHER(comb_rk45_f64, double)
COMB_RK45_LAUNCHER(comb_rk45_f32, float)
