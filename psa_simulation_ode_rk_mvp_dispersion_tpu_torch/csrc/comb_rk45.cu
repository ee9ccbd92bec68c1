// Batched adaptive (Dormand-Prince 5(4)) integration of the N-wave
// cascaded-FWM comb, one CUDA thread block per comb instance.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_comb_adaptive.py::_kernel_body   (K5, the comb rk45 kernel)
// with one template, comb_rk45_kernel<T>, T in {double, float}: float64
// serves x64/df32, float32 serves x32.
//
// What bounds it: arithmetic.  An attempted step is 6 RHS evaluations (the
// first stage is the last accepted step's seventh: FSAL), each 8*N*L real
// multiply-adds for the two dense DFTs, plus O(N) stage sums, error
// estimate and norm.  The state, the seven
// stages and the controller live in shared memory and registers for the
// whole integration; inputs are read once and outputs written once.  The
// controller is uniform within a block (one comb), so unlike the 4-wave
// kernel K3 no instance waits on another instance's steps: each block runs
// exactly its comb's attempts.
//
// The RHS and the block's layout are csrc/comb_common.cuh's, shared with
// csrc/comb_rk.cu.
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
//     max(|y_j|, |y5_j|)) and 0/0 read as 0, the sum taken by one thread in
//     index order, as the plain version sums it;
//   - accept when the step and its norm are finite and the norm <= 1; the
//     factor is clip(0.9 * pow(max(norm, 1e-16), -1/5), 0.2, 5), or 0.5 for a
//     non-finite step, and dt = max(dt * factor, dt_min);
//   - a rejected step with h <= dt_min clears ok, and so does a segment not
//     finished within max_steps; a failed comb keeps its last accepted state;
//   - after each saved segment P_max = max(P_max, |A|^2) (from |A0|^2);
//     y_last is the state at the end of the last saved segment.
//
// Global layout (row-major, one row per instance): gamma, alpha (B,); beta
// (B, N); tw (L, 2) = (cos, sin); y0 (B, 2N) = [Re A | Im A]; outputs pmax
// (B, N), y_last (B, 2N), ok (B,) uint8, n_accepted, n_rejected (B,) int32.
//
// Rounding: compiled with -fmad=false (ops/_build.py), so that every product
// and sum outside the DFTs rounds as the plain version's torch operations;
// the DFT sums run in another order than torch.matmul's, so the two agree to
// rounding and take the same steps on nearly every fp64 comb.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (ops/_build.py); bound with ctypes
// through the extern "C" functions at the end; the launchers return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "comb_common.cuh"

namespace {

using comb::Block;
using comb::kMaxThreads;
using comb::Pair;
using comb::rhs;
using comb::threads_for;

// vectors of 2N values in shared memory: y, x (stage input), y5, err, k1..k7
constexpr int kStateVectors = 11;

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

// The comb's integration state.  The pointers and the controller values are
// the same in every thread of the block.
template <typename T>
struct State {
    T *y, *x, *y5, *err, *k[7], *r2, *enorm;
    T dt;
    bool ok;
    int n_acc, n_rej;
};

// One Dormand-Prince attempt of size h from y with first stage k[0]: y5,
// err, and k[6] = f(y5).  Sums in the tableau's order.
template <typename T>
__device__ void dp45(const Block<T>& c, State<T>& s, T h) {
    const int n2 = 2 * c.n;
    T** k = s.k;
    for (int q = c.tid; q < n2; q += c.nt) s.x[q] = s.y[q] + (h * T(kA21)) * k[0][q];
    rhs(c, s.x, k[1]);
    for (int q = c.tid; q < n2; q += c.nt)
        s.x[q] = (s.y[q] + (h * T(kA31)) * k[0][q]) + (h * T(kA32)) * k[1][q];
    rhs(c, s.x, k[2]);
    for (int q = c.tid; q < n2; q += c.nt)
        s.x[q] = ((s.y[q] + (h * T(kA41)) * k[0][q]) + (h * T(kA42)) * k[1][q])
                 + (h * T(kA43)) * k[2][q];
    rhs(c, s.x, k[3]);
    for (int q = c.tid; q < n2; q += c.nt)
        s.x[q] = (((s.y[q] + (h * T(kA51)) * k[0][q]) + (h * T(kA52)) * k[1][q])
                  + (h * T(kA53)) * k[2][q]) + (h * T(kA54)) * k[3][q];
    rhs(c, s.x, k[4]);
    for (int q = c.tid; q < n2; q += c.nt)
        s.x[q] = ((((s.y[q] + (h * T(kA61)) * k[0][q]) + (h * T(kA62)) * k[1][q])
                   + (h * T(kA63)) * k[2][q]) + (h * T(kA64)) * k[3][q])
                 + (h * T(kA65)) * k[4][q];
    rhs(c, s.x, k[5]);
    // the seventh stage's input is the 5th-order solution (b5 = a7)
    for (int q = c.tid; q < n2; q += c.nt) {
        s.y5[q] = ((((s.y[q] + (h * T(kA71)) * k[0][q]) + (h * T(kA73)) * k[2][q])
                    + (h * T(kA74)) * k[3][q]) + (h * T(kA75)) * k[4][q])
                  + (h * T(kA76)) * k[5][q];
        s.err[q] = ((((T(0) + (h * T(kE1)) * k[0][q]) + (h * T(kE3)) * k[2][q])
                     + (h * T(kE4)) * k[3][q]) + (h * T(kE5)) * k[4][q])
                   + (h * T(kE6)) * k[5][q];
    }
    rhs(c, s.y5, k[6]);
    for (int q = c.tid; q < n2; q += c.nt) s.err[q] = s.err[q] + (h * T(kE7)) * k[6][q];
}

// Advance the comb over a segment of length len in local z.
template <typename T>
__device__ void advance(const Block<T>& c, State<T>& s, double len, T rtol, T atol,
                        int max_steps) {
    const int n = c.n;
    const T seg = T(len);
    const T dt_min = T(1e-12 * (len + 1.0));
    T z = T(0);
    for (int it = 0; it < max_steps && s.ok && z < seg; ++it) {
        const T h = fmin(s.dt, seg - z);
        dp45(c, s, h);
        __syncthreads();  // err and y5 of every component
        int fin = 1;
        for (int j = c.tid; j < n; j += c.nt) {
            const T p = s.y[j] * s.y[j] + s.y[n + j] * s.y[n + j];
            const T pn = s.y5[j] * s.y5[j] + s.y5[n + j] * s.y5[n + j];
            const T scale = atol + rtol * sqrt(fmax(p, pn));
            const T e = sqrt(s.err[j] * s.err[j] + s.err[n + j] * s.err[n + j]);
            const T r = scale > T(0) ? e / scale : T(0);
            s.r2[j] = r * r;
            fin &= (isfinite(s.y5[j]) && isfinite(s.y5[n + j])) ? 1 : 0;
        }
        const bool all_finite = __syncthreads_and(fin) != 0;
        if (c.tid == 0) {
            T sum = s.r2[0];
            for (int j = 1; j < n; ++j) sum = sum + s.r2[j];
            *s.enorm = sqrt(sum / T(n));
        }
        __syncthreads();
        const T enorm = *s.enorm;
        const bool finite = all_finite && isfinite(enorm);
        const bool accept = finite && enorm <= T(1);
        const T factor = finite
            ? fmin(fmax(T(0.9) * pow(fmax(enorm, T(1e-16)), T(-1.0 / 5.0)), T(0.2)), T(5))
            : T(0.5);
        s.dt = fmax(s.dt * factor, dt_min);
        if (accept) {
            z = z + h;
            T* t = s.y;
            s.y = s.y5;
            s.y5 = t;
            t = s.k[0];
            s.k[0] = s.k[6];
            s.k[6] = t;
            ++s.n_acc;
        } else {
            ++s.n_rej;
            if (h <= dt_min) s.ok = false;
        }
    }
    if (!(z >= seg)) s.ok = false;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
comb_rk45_kernel(const T* __restrict__ gamma, const T* __restrict__ alpha,
                 const T* __restrict__ beta, const T* __restrict__ tw, const T* __restrict__ y0,
                 T* __restrict__ pmax_out, T* __restrict__ y_last_out,
                 uint8_t* __restrict__ ok_out, int32_t* __restrict__ n_acc_out,
                 int32_t* __restrict__ n_rej_out, int n, int L, int n_chunks, double seg_len,
                 double tail_len, double dt0, T rtol, T atol, int max_steps) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, n2 = 2 * n;
    Pair<T>* tw_s = reinterpret_cast<Pair<T>*>(smem);
    Pair<T>* G = tw_s + L;
    T* beta_s = reinterpret_cast<T*>(G + L);
    T* pmax = beta_s + n;
    State<T> s;
    s.r2 = pmax + n;
    s.y = s.r2 + n;  // then kStateVectors vectors of 2N values, then the norm
    s.x = s.y + n2;
    s.y5 = s.x + n2;
    s.err = s.y5 + n2;
    for (int i = 0; i < 7; ++i) s.k[i] = s.err + (i + 1) * n2;
    s.enorm = s.k[6] + n2;

    for (int k = tid; k < L; k += nt) tw_s[k] = Pair<T>{tw[2 * k], tw[2 * k + 1]};
    for (int j = tid; j < n; j += nt) beta_s[j] = beta[static_cast<size_t>(b) * n + j];
    for (int q = tid; q < n2; q += nt) s.y[q] = y0[static_cast<size_t>(b) * n2 + q];
    __syncthreads();
    for (int j = tid; j < n; j += nt) pmax[j] = s.y[j] * s.y[j] + s.y[n + j] * s.y[n + j];

    Block<T> c{tw_s, G, beta_s, n, L, tid, nt, gamma[b], T(-0.5) * alpha[b], T(1) / T(L)};
    rhs(c, s.y, s.k[0]);
    s.dt = T(dt0);
    s.ok = true;
    s.n_acc = 0;
    s.n_rej = 0;

    for (int i = 0; i < n_chunks; ++i) {
        advance(c, s, seg_len, rtol, atol, max_steps);
        __syncthreads();
        for (int j = tid; j < n; j += nt) {
            const T P = s.y[j] * s.y[j] + s.y[n + j] * s.y[n + j];
            pmax[j] = P > pmax[j] ? P : pmax[j];
        }
    }
    __syncthreads();
    for (int q = tid; q < n2; q += nt) y_last_out[static_cast<size_t>(b) * n2 + q] = s.y[q];
    for (int j = tid; j < n; j += nt) pmax_out[static_cast<size_t>(b) * n + j] = pmax[j];
    if (tail_len > 0.0) advance(c, s, tail_len, rtol, atol, max_steps);
    if (tid == 0) {
        ok_out[b] = s.ok ? 1 : 0;
        n_acc_out[b] = s.n_acc;
        n_rej_out[b] = s.n_rej;
    }
}

size_t shared_bytes(int n, int L, size_t elem) {
    return elem * (4 * static_cast<size_t>(L) + 3 * static_cast<size_t>(n)
                   + 2 * static_cast<size_t>(kStateVectors) * n + 1);
}

template <typename T>
int launch(const void* gamma, const void* alpha, const void* beta, const void* tw,
           const void* y0, void* pmax, void* y_last, void* ok, void* n_acc, void* n_rej, int B,
           int n, int L, int n_chunks, double seg_len, double tail_len, double dt0, double rtol,
           double atol, int max_steps, void* stream) {
    const size_t smem = shared_bytes(n, L, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(comb_rk45_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    comb_rk45_kernel<T><<<B, threads_for(n, L), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(gamma), static_cast<const T*>(alpha), static_cast<const T*>(beta),
        static_cast<const T*>(tw), static_cast<const T*>(y0), static_cast<T*>(pmax),
        static_cast<T*>(y_last), static_cast<uint8_t*>(ok), static_cast<int32_t*>(n_acc),
        static_cast<int32_t*>(n_rej), n, L, n_chunks, seg_len, tail_len, dt0,
        static_cast<T>(rtol), static_cast<T>(atol), max_steps);
    return static_cast<int>(cudaGetLastError());
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
