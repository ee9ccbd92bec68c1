// Batched N-wave cascaded-FWM comb integration: RK4, AB4 or ABM4, one CUDA
// thread block per comb instance.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_comb.py::_kernel_body   (K4, the comb rk4/ab4/abm4 kernel)
// with one template, comb_rk_kernel<T, METHOD>, T in {double, float}:
// float64 serves x64/df32, float32 serves x32.
//
// What bounds it: arithmetic.  One RHS evaluation is 8*N*L real
// multiply-adds (the forward DFT of the N lines into L = 2^ceil(log2(2N-1))
// bins and the inverse DFT of F|F|^2 back onto the N lines), against a
// state of 2N values; at N = 64 that is 65,536 multiply-adds for 128
// numbers.  The state, the RK stages, the Adams history, the running P_max
// and the last saved state live in shared memory for the whole integration,
// and the inputs are read once and the outputs written once, so the step
// loop moves no device memory.  This first version sums the DFTs with
// scalar FMAs from shared memory (a twiddle load for every two
// multiply-adds); tensor cores, wgmma and an in-shared-memory FFT are later
// work.  The RHS and the block's layout (blockDim = min(256, max(L, 2N))
// rounded up to 32; loops stride by it) are in csrc/comb_common.cuh.
//
// What it computes (the contract of ops/integrators.integrate_reduce over a
// (B, N) state with models/nwave.make_rhs_nwave('dft'), and of the TPU
// kernel it replaces; ops/cuda_comb.solve_comb_batch_torch is the plain
// version):
//   - the RHS of csrc/comb_common.cuh;
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
//   gamma, alpha (B,); beta (B, N); tw (L, 2) = (cos, sin); y0 (B, 2N) =
//   [Re A | Im A]; outputs pmax (B, N), y_last (B, 2N), ok (B,) uint8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" functions at the end; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "comb_common.cuh"

namespace {

using comb::Block;
using comb::kMaxThreads;
using comb::Pair;
using comb::rhs;
using comb::threads_for;

constexpr int kRK4 = 0;
constexpr int kAB4 = 1;
constexpr int kABM4 = 2;
// vectors of 2N values in shared memory: y, x (RHS input), k (RHS output),
// acc (stage sum / increment), k1, comp, f1, f2, f3, y_last
constexpr int kStateVectors = 10;

template <typename T>
constexpr bool kCompensated = std::is_same<T, float>::value;

// The per-instance integration state in shared memory.
template <typename T>
struct State {
    T *y, *x, *k, *acc, *k1, *comp, *f1, *f2, *f3, *y_last, *pmax;
    bool ok;
    int to_save;
};

// Step constants, formed in double and rounded once to T, as the plain
// version's Python floats are.
template <typename T>
struct Steps {
    T dz, half, sixth, w24;
};

// One RK4 increment of y into s.acc; s.k1 = f(y).
template <typename T>
__device__ void rk4(const Block<T>& c, State<T>& s, const Steps<T>& h) {
    const int n2 = 2 * c.n;
    const T dz = h.dz, half = h.half, sixth = h.sixth;
    rhs(c, s.y, s.k1);
    for (int q = c.tid; q < n2; q += c.nt) s.x[q] = s.y[q] + half * s.k1[q];
    rhs(c, s.x, s.k);
    for (int q = c.tid; q < n2; q += c.nt) {
        s.acc[q] = s.k1[q] + T(2) * s.k[q];
        s.x[q] = s.y[q] + half * s.k[q];
    }
    rhs(c, s.x, s.k);
    for (int q = c.tid; q < n2; q += c.nt) {
        s.acc[q] = s.acc[q] + T(2) * s.k[q];
        s.x[q] = s.y[q] + dz * s.k[q];
    }
    rhs(c, s.x, s.k);
    for (int q = c.tid; q < n2; q += c.nt) s.acc[q] = sixth * (s.acc[q] + s.k[q]);
}

// y += acc (compensated in float32) unless a component of the new state is
// not finite (then the lane freezes and clears ok), then the save-grid
// reductions when the step count reaches a multiple of save_every.
template <typename T>
__device__ void keep(const Block<T>& c, State<T>& s, bool check_nan, int save_every) {
    const int n2 = 2 * c.n;
    int fin = 1;
    for (int q = c.tid; q < n2; q += c.nt) {
        T y_new;
        if constexpr (kCompensated<T>) {
            const T corrected = s.acc[q] - s.comp[q];
            y_new = s.y[q] + corrected;
            s.acc[q] = (y_new - s.y[q]) - corrected;  // the new compensation
        } else {
            y_new = s.y[q] + s.acc[q];
        }
        s.x[q] = y_new;
        fin &= isfinite(y_new) ? 1 : 0;
    }
    const bool all_finite = __syncthreads_and(fin) != 0;
    if (!check_nan || (s.ok && all_finite)) {
        for (int q = c.tid; q < n2; q += c.nt) {
            s.y[q] = s.x[q];
            if constexpr (kCompensated<T>) s.comp[q] = s.acc[q];
        }
    } else {
        s.ok = false;
    }
    if (--s.to_save == 0) {
        s.to_save = save_every;
        __syncthreads();
        for (int j = c.tid; j < c.n; j += c.nt) {
            const T P = s.y[j] * s.y[j] + s.y[c.n + j] * s.y[c.n + j];
            s.pmax[j] = P > s.pmax[j] ? P : s.pmax[j];
        }
        for (int q = c.tid; q < n2; q += c.nt) s.y_last[q] = s.y[q];
    }
}

template <typename T, int METHOD>
__global__ void __launch_bounds__(kMaxThreads)
comb_rk_kernel(const T* __restrict__ gamma, const T* __restrict__ alpha,
               const T* __restrict__ beta, const T* __restrict__ tw, const T* __restrict__ y0,
               T* __restrict__ pmax_out, T* __restrict__ y_last_out,
               uint8_t* __restrict__ ok_out, int n, int L, int n_steps, int save_every,
               int check_nan, double dz) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, n2 = 2 * n;
    Pair<T>* tw_s = reinterpret_cast<Pair<T>*>(smem);
    Pair<T>* G = tw_s + L;
    T* beta_s = reinterpret_cast<T*>(G + L);
    State<T> s;
    s.pmax = beta_s + n;
    s.y = s.pmax + n;  // then kStateVectors vectors of 2N values
    s.x = s.y + n2;
    s.k = s.x + n2;
    s.acc = s.k + n2;
    s.k1 = s.acc + n2;
    s.comp = s.k1 + n2;
    s.f1 = s.comp + n2;
    s.f2 = s.f1 + n2;
    s.f3 = s.f2 + n2;
    s.y_last = s.f3 + n2;

    for (int k = tid; k < L; k += nt) tw_s[k] = Pair<T>{tw[2 * k], tw[2 * k + 1]};
    for (int j = tid; j < n; j += nt) beta_s[j] = beta[static_cast<size_t>(b) * n + j];
    for (int q = tid; q < n2; q += nt) {
        const T y = y0[static_cast<size_t>(b) * n2 + q];
        s.y[q] = y;
        s.y_last[q] = y;
        s.comp[q] = T(0);
    }
    __syncthreads();
    for (int j = tid; j < n; j += nt) s.pmax[j] = s.y[j] * s.y[j] + s.y[n + j] * s.y[n + j];

    Block<T> c{tw_s, G, beta_s, n, L, tid, nt, gamma[b], T(-0.5) * alpha[b], T(1) / T(L)};
    s.ok = true;
    s.to_save = save_every;
    const bool nan_check = check_nan != 0;
    const Steps<T> h{T(dz), T(0.5 * dz), T(dz / 6.0), T(dz / 24.0)};

    if (METHOD == kRK4) {
        for (int i = 0; i < n_steps; ++i) {
            rk4(c, s, h);
            keep(c, s, nan_check, save_every);
        }
    } else {
        // f1, f2, f3: f at steps n-1, n-2, n-3
        const int n_boot = n_steps < 3 ? n_steps : 3;
        for (int i = 0; i < n_boot; ++i) {
            rk4(c, s, h);
            for (int q = tid; q < n2; q += nt) {
                s.f3[q] = s.f2[q];
                s.f2[q] = s.f1[q];
                s.f1[q] = s.k1[q];
            }
            keep(c, s, nan_check, save_every);
        }
        const T w = h.w24;
        for (int i = n_boot; i < n_steps; ++i) {
            rhs(c, s.y, s.k);  // f0
            for (int q = tid; q < n2; q += nt)
                s.acc[q] = w * (((T(55) * s.k[q] - T(59) * s.f1[q]) + T(37) * s.f2[q])
                                - T(9) * s.f3[q]);
            if (METHOD == kABM4) {
                for (int q = tid; q < n2; q += nt) s.x[q] = s.y[q] + s.acc[q];
                rhs(c, s.x, s.k1);  // f(y_pred)
                for (int q = tid; q < n2; q += nt)
                    s.acc[q] = w * (((T(9) * s.k1[q] + T(19) * s.k[q]) - T(5) * s.f1[q])
                                    + s.f2[q]);
            }
            keep(c, s, nan_check, save_every);
            for (int q = tid; q < n2; q += nt) {
                s.f3[q] = s.f2[q];
                s.f2[q] = s.f1[q];
                s.f1[q] = s.k[q];
            }
        }
    }

    __syncthreads();
    for (int j = tid; j < n; j += nt) pmax_out[static_cast<size_t>(b) * n + j] = s.pmax[j];
    for (int q = tid; q < n2; q += nt) y_last_out[static_cast<size_t>(b) * n2 + q] = s.y_last[q];
    if (tid == 0) ok_out[b] = s.ok ? 1 : 0;
}

size_t shared_bytes(int n, int L, size_t elem) {
    return elem * (4 * static_cast<size_t>(L) + 2 * static_cast<size_t>(n)
                   + 2 * static_cast<size_t>(kStateVectors) * n);
}

template <typename T, int METHOD>
int launch(const void* gamma, const void* alpha, const void* beta, const void* tw,
           const void* y0, void* pmax, void* y_last, void* ok, int B, int n, int L, int n_steps,
           int save_every, int check_nan, double dz, void* stream) {
    const size_t smem = shared_bytes(n, L, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(comb_rk_kernel<T, METHOD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    comb_rk_kernel<T, METHOD><<<B, threads_for(n, L), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(gamma), static_cast<const T*>(alpha), static_cast<const T*>(beta),
        static_cast<const T*>(tw), static_cast<const T*>(y0), static_cast<T*>(pmax),
        static_cast<T*>(y_last), static_cast<uint8_t*>(ok), n, L, n_steps, save_every, check_nan,
        dz);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" int comb_rk_shared_bytes(int n, int L, int elem) {
    return static_cast<int>(shared_bytes(n, L, static_cast<size_t>(elem)));
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
