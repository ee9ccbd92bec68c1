// Batched N-wave cascaded-FWM comb integration: RK4, AB4 or ABM4, one CUDA
// thread block per comb instance.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_comb.py::_kernel_body   (K4, the comb rk4/ab4/abm4 kernel)
// with one template, comb_rk_kernel<T, METHOD, LPT>, T in {double, float}:
// float64 serves x64/df32, float32 serves x32; LPT the lines a thread.
//
// What bounds it: the latency of the transform passes more than their
// arithmetic (on an H100 the fp64 kernel runs at 14% of the flop bound).
// One RHS evaluation is the cubic sum through two L-point FFTs (about 10 L
// log2 L flop, csrc/comb_common.cuh's comb::Coupling) and O(N) pointwise
// work, against a state of 2N values; at N = 64 (L = 128) one comb is one
// warp of 32 threads, 2 lines a thread, and 4,096 combs are about 31 warps
// an SM, as many as the registers allow at once (fp64 takes 80 a thread,
// so 25 combs an SM fit; fp32 64, so 32).  A thread holds its lines' state, stage input, stage sum and
// derivative (and the Adams history, and in float32 the compensation) in
// registers for the whole integration; the transforms run in the comb's
// 3 L complex values of shared memory with a barrier of the comb's threads
// between passes (__syncwarp for a one-warp comb: no block barrier in the
// step), every butterfly in double on a float64 table.  The inputs are read
// once; P_max and the last saved state go to device memory at each save.
// Wider combs (L > 128) take more threads, up to 256 a comb, then more
// lines a thread (LPT 4 at L = 2,048, 8 at 4,096, N <= 2,048).
//
// What it computes (the contract of ops/integrators.integrate_reduce over a
// (B, N) state with the comb RHS, and of the TPU kernel it replaces;
// ops/cuda_comb.solve_comb_batch_torch is the plain version, whose cubic sum
// ops/cuda_comb.kernel_polarization computes with this kernel's passes and
// rounding points):
//   - the RHS of csrc/comb_common.cuh (the FFT coupling);
//   - RK4: y + dz/6 * (((k1 + 2 k2) + 2 k3) + k4);
//   - AB4/ABM4: 3 RK4 startup steps that record k1 = f(y_n), then
//     y + dz/24*(55 f0 - 59 f1 + 37 f2 - 9 f3) and, for ABM4, the corrector
//     y + dz/24*(9 f(y_pred) + 19 f0 - 5 f1 + f2);
//   - in float32 only, each step's increment is added with compensated
//     (Kahan) summation, as ops/integrators.py does;
//   - with check_nan set, a lane whose new state has a non-finite component
//     (isfinite, in both types) keeps its last finite state and clears ok;
//   - at every step multiple of save_every, P_max = max(P_max, |A|^2) and
//     y_last = y; both start from y0; the trailing n_steps % save_every
//     steps are integrated but feed only ok.
//
// Global layout (row-major, one row per instance):
//   gamma, alpha (B,); beta (B, N); tw (L, 2) = (cos, sin)(2 pi k / L) in
//   float64, L = max(128, 2^ceil(log2(2N-1))); y0 (B, 2N) = [Re A | Im A];
//   outputs pmax (B, N), y_last (B, 2N), ok (B,) uint8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" functions at the end; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "comb_common.cuh"

namespace {

using comb::Coupling;
using Cd = ssfm::Cx<double>;

constexpr int kRK4 = 0;
constexpr int kAB4 = 1;
constexpr int kABM4 = 2;
// buffers of L complex values a comb keeps in shared memory
constexpr int kBuffers = 3;

template <typename T>
constexpr bool kCompensated = std::is_same<T, float>::value;

// One comb's integration: its coupling and its lines' state in registers.
template <typename T, int METHOD, int LPT>
struct Lines {
    using Cx = ssfm::Cx<T>;
    static constexpr bool kAdams = METHOD != kRK4;
    Coupling<T, LPT> c;
    T dz, half, sixth, w24;  // formed in double and rounded once, as the plain version's floats
    Cx y[LPT], x[LPT], acc[LPT], k[LPT];
    Cx kp[kAdams ? LPT : 1], f1[kAdams ? LPT : 1], f2[kAdams ? LPT : 1], f3[kAdams ? LPT : 1];
    Cx comp[kCompensated<T> ? LPT : 1];
    bool ok;
    int to_save;

    // One RK4 increment of y into acc; with Record, f1..f3 shift in k1 = f(y).
    template <bool Record>
    __device__ __forceinline__ void rk4() {
        c.rhs(y, k);
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            if constexpr (Record) {
                f3[i] = f2[i];
                f2[i] = f1[i];
                f1[i] = k[i];
            }
            acc[i] = k[i];
            x[i] = Cx{y[i].re + half * k[i].re, y[i].im + half * k[i].im};
        }
        c.rhs(x, k);
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            acc[i] = Cx{acc[i].re + T(2) * k[i].re, acc[i].im + T(2) * k[i].im};
            x[i] = Cx{y[i].re + half * k[i].re, y[i].im + half * k[i].im};
        }
        c.rhs(x, k);
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            acc[i] = Cx{acc[i].re + T(2) * k[i].re, acc[i].im + T(2) * k[i].im};
            x[i] = Cx{y[i].re + dz * k[i].re, y[i].im + dz * k[i].im};
        }
        c.rhs(x, k);
#pragma unroll
        for (int i = 0; i < LPT; ++i)
            acc[i] = Cx{sixth * (acc[i].re + k[i].re), sixth * (acc[i].im + k[i].im)};
    }

    // y += acc (compensated in float32) unless a component of the new state
    // is not finite (then the lane freezes and clears ok), then the
    // save-grid reductions when the step count reaches a multiple of
    // save_every.
    __device__ __forceinline__ void keep(bool check_nan, int save_every, T* pmax, T* y_last) {
        int fin = 1;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            if constexpr (kCompensated<T>) {
                const T cr = acc[i].re - comp[i].re, ci = acc[i].im - comp[i].im;
                x[i] = Cx{y[i].re + cr, y[i].im + ci};
                acc[i] = Cx{(x[i].re - y[i].re) - cr, (x[i].im - y[i].im) - ci};  // the new compensation
            } else {
                x[i] = Cx{y[i].re + acc[i].re, y[i].im + acc[i].im};
            }
            fin &= (isfinite(x[i].re) && isfinite(x[i].im)) ? 1 : 0;
        }
        const bool all_finite = c.all(fin != 0);
        if (!check_nan || (ok && all_finite)) {
#pragma unroll
            for (int i = 0; i < LPT; ++i) {
                y[i] = x[i];
                if constexpr (kCompensated<T>) comp[i] = acc[i];
            }
        } else {
            ok = false;
        }
        if (--to_save == 0) {
            to_save = save_every;
            save(pmax, y_last);
        }
    }

    // P_max = max(P_max, |y|^2) and y_last = y for the thread's lines.
    __device__ __forceinline__ void save(T* pmax, T* y_last) const {
        const int n = c.n;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            const int j = c.line(i);
            if (j < n) {
                const T P = y[i].re * y[i].re + y[i].im * y[i].im;
                const T m = pmax[j];
                pmax[j] = P > m ? P : m;
                y_last[j] = y[i].re;
                y_last[n + j] = y[i].im;
            }
        }
    }

    __device__ __forceinline__ void integrate(int n_steps, int save_every, bool check_nan,
                                              T* pmax, T* y_last) {
        if constexpr (METHOD == kRK4) {
            for (int s = 0; s < n_steps; ++s) {
                rk4<false>();
                keep(check_nan, save_every, pmax, y_last);
            }
        } else {
            // f1, f2, f3: f at steps n-1, n-2, n-3
            const int n_boot = n_steps < 3 ? n_steps : 3;
            for (int s = 0; s < n_boot; ++s) {
                rk4<true>();
                keep(check_nan, save_every, pmax, y_last);
            }
            for (int s = n_boot; s < n_steps; ++s) {
                c.rhs(y, k);  // f0
#pragma unroll
                for (int i = 0; i < LPT; ++i)
                    acc[i] = Cx{w24 * (((T(55) * k[i].re - T(59) * f1[i].re) + T(37) * f2[i].re)
                                       - T(9) * f3[i].re),
                                w24 * (((T(55) * k[i].im - T(59) * f1[i].im) + T(37) * f2[i].im)
                                       - T(9) * f3[i].im)};
                if constexpr (METHOD == kABM4) {
#pragma unroll
                    for (int i = 0; i < LPT; ++i)
                        x[i] = Cx{y[i].re + acc[i].re, y[i].im + acc[i].im};
                    c.rhs(x, kp);  // f(y_pred)
#pragma unroll
                    for (int i = 0; i < LPT; ++i)
                        acc[i] = Cx{w24 * (((T(9) * kp[i].re + T(19) * k[i].re) - T(5) * f1[i].re)
                                           + f2[i].re),
                                    w24 * (((T(9) * kp[i].im + T(19) * k[i].im) - T(5) * f1[i].im)
                                           + f2[i].im)};
                }
                keep(check_nan, save_every, pmax, y_last);
#pragma unroll
                for (int i = 0; i < LPT; ++i) {
                    f3[i] = f2[i];
                    f2[i] = f1[i];
                    f1[i] = k[i];
                }
            }
        }
    }
};

template <typename T, int METHOD, int LPT>
__global__ void __launch_bounds__(comb::kMaxThreads)
comb_rk_kernel(const T* __restrict__ gamma, const T* __restrict__ alpha,
               const T* __restrict__ beta, const Cd* __restrict__ tw, const T* __restrict__ y0,
               T* __restrict__ pmax_out, T* __restrict__ y_last_out,
               uint8_t* __restrict__ ok_out, int n, int L, int n_steps, int save_every,
               int check_nan, double dz) {
    extern __shared__ __align__(16) unsigned char smem[];
    using Cx = ssfm::Cx<T>;
    const int b = blockIdx.x, n2 = 2 * n;
    Lines<T, METHOD, LPT> s;
    s.c.f = ssfm::plan(tw, L, 1, threadIdx.x, blockDim.x);
    Cx* buf = reinterpret_cast<Cx*>(smem);
    s.c.b0 = buf;
    s.c.b1 = buf + L;
    s.c.b2 = buf + 2 * L;
    s.c.n = n;
    s.c.gamma = gamma[b];
    s.c.nha = T(-0.5) * alpha[b];
    s.dz = T(dz);
    s.half = T(0.5 * dz);
    s.sixth = T(dz / 6.0);
    s.w24 = T(dz / 24.0);
    T* pmax = pmax_out + static_cast<size_t>(b) * n;
    T* y_last = y_last_out + static_cast<size_t>(b) * n2;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
        const int j = s.c.line(i);
        const bool in = j < n;
        s.c.beta[i] = in ? beta[static_cast<size_t>(b) * n + j] : T(0);
        s.y[i] = in ? Cx{y0[static_cast<size_t>(b) * n2 + j], y0[static_cast<size_t>(b) * n2 + n + j]}
                    : Cx{T(0), T(0)};
        s.k[i] = Cx{T(0), T(0)};
        if constexpr (Lines<T, METHOD, LPT>::kAdams)
            s.f1[i] = s.f2[i] = s.f3[i] = s.kp[i] = Cx{T(0), T(0)};
        if constexpr (kCompensated<T>) s.comp[i] = Cx{T(0), T(0)};
        if (in) {  // P_max and y_last start from y0
            pmax[j] = s.y[i].re * s.y[i].re + s.y[i].im * s.y[i].im;
            y_last[j] = s.y[i].re;
            y_last[n + j] = s.y[i].im;
        }
    }
    s.ok = true;
    s.to_save = save_every;
    s.integrate(n_steps, save_every, check_nan != 0, pmax, y_last);
    if (threadIdx.x == 0) ok_out[b] = s.ok ? 1 : 0;
}

size_t shared_bytes(int L, size_t elem) {
    return 2 * elem * kBuffers * static_cast<size_t>(L);
}

// Whether the kernel takes L: a power of two from 128 to 4,096 (LPT <= 8).
bool takes(int n, int L) {
    return L >= 128 && L <= 4096 && (L & (L - 1)) == 0 && 2 * n - 1 <= L;
}

template <typename T, int METHOD, int LPT>
int launch_lines(const void* gamma, const void* alpha, const void* beta, const void* tw,
                 const void* y0, void* pmax, void* y_last, void* ok, int B, int n, int L,
                 int n_steps, int save_every, int check_nan, double dz, void* stream) {
    const size_t smem = shared_bytes(L, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(comb_rk_kernel<T, METHOD, LPT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    comb_rk_kernel<T, METHOD, LPT>
        <<<B, comb::coupling_threads(L), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(gamma), static_cast<const T*>(alpha), static_cast<const T*>(beta),
        static_cast<const Cd*>(tw), static_cast<const T*>(y0), static_cast<T*>(pmax),
        static_cast<T*>(y_last), static_cast<uint8_t*>(ok), n, L, n_steps, save_every, check_nan,
        dz);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int METHOD>
int launch(const void* gamma, const void* alpha, const void* beta, const void* tw,
           const void* y0, void* pmax, void* y_last, void* ok, int B, int n, int L, int n_steps,
           int save_every, int check_nan, double dz, void* stream) {
    if (!takes(n, L)) return static_cast<int>(cudaErrorInvalidValue);
#define COMB_RK_ARGS                                                                            \
    gamma, alpha, beta, tw, y0, pmax, y_last, ok, B, n, L, n_steps, save_every, check_nan, dz, \
        stream
    switch (comb::coupling_lines(L)) {
        case 2:
            return launch_lines<T, METHOD, 2>(COMB_RK_ARGS);
        case 4:
            return launch_lines<T, METHOD, 4>(COMB_RK_ARGS);
        default:
            return launch_lines<T, METHOD, 8>(COMB_RK_ARGS);
    }
#undef COMB_RK_ARGS
}

}  // namespace

// Bytes of dynamic shared memory one block takes (n is not needed; kept
// for the interface K5's function shares).
extern "C" int comb_rk_shared_bytes(int n, int L, int elem) {
    (void)n;
    return static_cast<int>(shared_bytes(L, static_cast<size_t>(elem)));
}

#define COMB_RK_LAUNCHER(NAME, T, METHOD)                                                      \
    extern "C" int NAME(const void* gamma, const void* alpha, const void* beta, const void* tw, \
                        const void* y0, void* pmax, void* y_last, void* ok, int B, int n,       \
                        int L, int n_steps, int save_every, int check_nan, double dz,           \
                        void* stream) {                                                         \
        return launch<T, METHOD>(gamma, alpha, beta, tw, y0, pmax, y_last, ok, B, n, L,         \
                                 n_steps, save_every, check_nan, dz, stream);                  \
    }

COMB_RK_LAUNCHER(comb_rk4_f64, double, kRK4)
COMB_RK_LAUNCHER(comb_ab4_f64, double, kAB4)
COMB_RK_LAUNCHER(comb_abm4_f64, double, kABM4)
COMB_RK_LAUNCHER(comb_rk4_f32, float, kRK4)
COMB_RK_LAUNCHER(comb_ab4_f32, float, kAB4)
COMB_RK_LAUNCHER(comb_abm4_f32, float, kABM4)
