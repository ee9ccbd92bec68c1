// Batched fixed-step GNLSE integration by the symmetric (Strang) split-step
// Fourier method, one CUDA thread block per envelope, the whole integration
// in one launch.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_gnlse.py::_kernel_body   (K6, the fused GNLSE SSFM kernel)
// with two templates, T in {double, float}: float64 serves x64/df32, float32
// serves x32; gnlse_ssfm_kernel<T, S> the Kerr rotation,
// gnlse_nl_kernel<T, S> the nonlinear terms.  Its affine build (K7, the LLE
// cavity) is csrc/lle_ssfm.cu, on the same Strang body as the Kerr route.
//
// What it computes (the contract of models/gnlse.gnlse_fixed with method
// 'strang', which ops/cuda_gnlse.solve_gnlse_batch_torch runs, and of
// _gnlse_reduce_solver in the JAX package):
//   - every save chunk of k steps is Lh, (NL, Lf)^(k-1), NL, Lh, with the
//     linear substep y <- IDFT(L * DFT(y)) and L = Lh or Lf the factors
//     exp((-alpha/2 + i phi) dz/2) and exp((-alpha/2 + i phi) dz) that the
//     wrapper builds with the plain version's own function (shared (n,) or
//     one row per envelope);
//   - NL is the exact Kerr rotation y exp(i (gamma |y|^2) dz) or, with the
//     nonlinear terms, one RK4 step of models/gnlse._nl_rhs:
//       P = |y|^2, R = Re IDFT(conj(H_R) DFT(P)), W = y ((1 - f_R) P + f_R R),
//       N = i gamma (W - (i/omega_0) IDFT(i omega DFT(W))),
//     where the Raman transforms drop out when f_R = 0 and the steepening
//     ones when 1/omega_0 = 0;
//   - ok starts as "y0 is finite"; after each chunk a non-finite state
//     clears ok and the envelope keeps its last good state (which it then
//     keeps for good: the rest of the run cannot change its outputs, so the
//     block stops); otherwise the state is saved and the peak, the running
//     max over saved samples of max_t |y|^2 (from y0, NaN propagating),
//     grows; the trailing n_steps % save_every steps are integrated from the
//     last saved state and feed only ok.
//
// What bounds it: arithmetic and the barriers between transform passes.  A
// Kerr step is one transform pair (about 10 n log2 n flop) and O(n)
// pointwise work on a state of n samples; an nl step adds four evaluations
// of N, each a Raman pair on the real power and a steepening pair.  The
// state lives in shared memory for the whole integration; each envelope
// reads its input once and writes its outputs (and its saved state, once a
// chunk) to device memory.  The linear factors, the twiddles, conj(H_R) and
// omega are read from device memory through the cache, so that the shared
// memory holds only state-sized buffers.
//   - Kerr (gnlse_ssfm_kernel<T, S>): csrc/strang.cuh's slotted
//     Strang body, as K7 (csrc/lle_ssfm.cu) runs it without the affine
//     write: radix-4 slot_fft passes, the factor product in the forward
//     transform's last pass, the 1/n and the next substep's Kerr rotation in
//     the inverse one's, each thread's factors in registers, one fused
//     reduction at a chunk's end; 10 barriers a step at n = 1,024 (22 with
//     radix-2 passes and separate factor and Kerr passes).  2 buffers, y and
//     its transform partner.  K9's rotation body (csrc/vgnlse_ssfm.cu) runs
//     the same body on two polarizations with the same operations for each,
//     so that it gives K6's outputs bit for bit on an empty polarization.
//   - nl (gnlse_nl_kernel): 3 buffers, y and the transform pair; the RK4
//     sums k1 + 2(k2 + k3) and the stage derivative stay in registers of
//     the thread that owns the samples (sample j = tid + i nt, the same in
//     every pointwise loop), so that at n = 1,024 in fp64 a block takes
//     49,408 bytes, not 7 buffers' 114,944.  The transforms are the wide
//     radix-4 passes (ssfm_common.cuh's wide_fft: 5 passes a transform at
//     n = 1,024, not 10); the Raman pair transforms the real power as n/2
//     complex samples (raman_spectrum unpacks, multiplies by conj(H_R) and
//     repacks in one pass); the linear factor, the inverse's 1/n and the
//     steepening factor act in the last pass of their transforms, since
//     W - (i/omega_0) IDFT(i omega DFT(W)) = IDFT((1 + omega/omega_0) DFT(W)).
//     The samples a thread owns are a template constant (2, 4 or 8), and
//     every function of the nl path is force-inlined: the stepper's fields
//     and sums are then registers, where a call would put them in a stack
//     frame in local memory.
// At n = 2048 the fp64 Kerr block takes 65,792 bytes and the nl block
// 98,560, inside the 232,448 a Hopper block may use.
//
// Global layout (row-major, one row per envelope, complex as (re, im)):
//   y0 (B, n); lh, lf (n,) with fac_stride 0 or (B, n) with fac_stride n;
//   gamma (B,); tw (n,) = (cos, sin)(2 pi k / n) in float64; hrc (n,) = conj(H_R);
//   omega (n,); outputs peak (B,), y_last (B, n), ok (B,) uint8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" functions at the end; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "strang.cuh"

namespace {

using ssfm::Block;
using ssfm::Cx;

constexpr int kKerrBuffers = 2;
constexpr int kNlBuffers = 3;
constexpr int kReduceSlots = 32;

// The Kerr route's pointwise operator: no end write, and the NL the exact
// rotation y exp(i (g |y|^2) h).
template <typename T>
struct Kerr {
    T g, h;
    __device__ __forceinline__ Cx<T> end(bool, const Cx<T>& x) const { return x; }
    __device__ __forceinline__ void step(Cx<T> (&a)[1]) const { a[0] = ssfm::kerr_of(a[0], g, h); }
};

// One envelope's nl integration: y in shared memory, the RK4 sums in
// registers (slot i of a thread is sample tid + i nt, S slots a thread).
template <typename T, int S>
struct NlStepper {
    Block<T> c;
    ssfm::Plan full, half;  // the n-point transform; the n/2-point one of a real p
    Cx<T>*y, *b1, *b2;      // the state and the transform pair (a permutation)
    const Cx<T>*lh, *lf;
    const Cx<T>* hrc;
    const T* omega;
    T g, h, one_m_fr, fr, inv_w0;
    bool raman, steep;
    Cx<T> a[S], s[S];  // k1, then k1 + 2(k2 + k3); k2, then the k4 stage input

    __device__ __forceinline__ int at(int i) const { return c.tid + i * c.nt; }

    // y <- IDFT(L * DFT(y)), L applied in the forward transform's last pass.
    __device__ __forceinline__ void lin(const Cx<T>* L) {
        Cx<T>* f = ssfm::wide_fft<T, false, 1, S>(full, y, b1, ssfm::MulBy<T>{L, c.n});
        Cx<T>* r = ssfm::wide_fft<T, true, 1, S>(full, f, f == y ? b1 : y, ssfm::Scale{c.inv_n});
        if (r != y) {
            b1 = y;
            y = r;
        }
    }

    // out(i, N(x)) for each slot i, x = in(i) (models/gnlse._nl_rhs).
    template <class In, class Out>
    __device__ __forceinline__ void stage(const In& in, const Out& out) {
        const int n = c.n;
        const T* R = nullptr;  // the Raman response, n reals
        __syncthreads();       // the last stage's reads of b1 and b2 are done
        if (raman) {
            T* p = reinterpret_cast<T*>(b1);
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const int j = at(i);
                if (j < n) {
                    const Cx<T> v = in(i);
                    p[j] = v.re * v.re + v.im * v.im;
                }
            }
            Cx<T>* z = ssfm::wide_fft<T, false, 1, S>(half, b1, b2, ssfm::NoPost{});
            ssfm::raman_spectrum(half, z, hrc);
            R = reinterpret_cast<const T*>(
                ssfm::wide_fft<T, true, 1, S>(half, z, z == b1 ? b2 : b1, ssfm::Scale{c.inv_n}));
        }
        Cx<T>* w = R == reinterpret_cast<const T*>(b1) ? b2 : b1;
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const int j = at(i);
            if (j < n) {
                const Cx<T> v = in(i);
                const T P = v.re * v.re + v.im * v.im;
                const T fac = raman ? one_m_fr * P + fr * R[j] : one_m_fr * P;
                const Cx<T> W{v.re * fac, v.im * fac};
                if (steep)
                    w[j] = W;
                else
                    out(i, Cx<T>{-(g * W.im), g * W.re});
            }
        }
        if (!steep) return;
        // W - (i/omega_0) IDFT(i omega DFT(W)) = IDFT((1 + omega/omega_0) DFT(W))
        Cx<T>* f = ssfm::wide_fft<T, false, 1, S>(full, w, w == b1 ? b2 : b1,
                                               ssfm::Steep<T>{omega, double(inv_w0)});
        const Cx<T>* V =
            ssfm::wide_fft<T, true, 1, S>(full, f, f == b1 ? b2 : b1, ssfm::Scale{c.inv_n});
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const int j = at(i);
            if (j < n) out(i, Cx<T>{-(g * V[j].im), g * V[j].re});
        }
    }

    // One RK4 step of length h on y, in the plain version's order:
    // y + h/6 ((k1 + 2 (k2 + k3)) + k4).
    __device__ __forceinline__ void nl() {
        const T hh = T(0.5) * h, sixth = h / T(6);
        stage([&](int i) { return y[at(i)]; }, [&](int i, const Cx<T>& d) { a[i] = d; });
        stage([&](int i) {
                  const Cx<T> v = y[at(i)];
                  return Cx<T>{v.re + hh * a[i].re, v.im + hh * a[i].im};
              },
              [&](int i, const Cx<T>& d) { s[i] = d; });
        stage([&](int i) {
                  const Cx<T> v = y[at(i)];
                  return Cx<T>{v.re + hh * s[i].re, v.im + hh * s[i].im};
              },
              [&](int i, const Cx<T>& d) {
                  const Cx<T> v = y[at(i)];
                  const Cx<T> s23{s[i].re + d.re, s[i].im + d.im};
                  a[i] = Cx<T>{a[i].re + T(2) * s23.re, a[i].im + T(2) * s23.im};
                  s[i] = Cx<T>{v.re + h * d.re, v.im + h * d.im};
              });
        stage([&](int i) { return s[i]; },
              [&](int i, const Cx<T>& d) {
                  Cx<T>& v = y[at(i)];
                  v = Cx<T>{v.re + sixth * (a[i].re + d.re), v.im + sixth * (a[i].im + d.im)};
              });
    }

    // k fused symmetric steps: Lh, (NL, Lf)^(k-1), NL, Lh.
    __device__ __forceinline__ void steps(int kk) {
        lin(lh);
        for (int i = 1; i < kk; ++i) {
            nl();
            lin(lf);
        }
        nl();
        lin(lh);
    }
};

// The loop every kernel of this file runs over one envelope: y0 in, then
// save chunks of st.steps(save_every) with the finite check, the save and the
// peak, then the trailing steps.
template <typename T, class St>
__device__ __forceinline__ void integrate(St& st, const Cx<T>* y0, T* pk_out, Cx<T>* y_last,
                                          uint8_t* ok_out, int n_steps, int save_every) {
    const Block<T>& c = st.c;
    const int b = blockIdx.x, n = c.n;
    Cx<T>* out = y_last + static_cast<size_t>(b) * n;
    for (int j = c.tid; j < n; j += c.nt) {
        const Cx<T> v = y0[static_cast<size_t>(b) * n + j];
        st.y[j] = v;
        out[j] = v;
    }
    bool ok = ssfm::block_finite(c, st.y);
    T pk = ssfm::block_peak(c, st.y);
    const int n_chunks = n_steps / save_every, rem = n_steps - n_chunks * save_every;
    if (ok) {
        for (int i = 0; i < n_chunks; ++i) {
            st.steps(save_every);
            if (!ssfm::block_finite(c, st.y)) {
                ok = false;  // y_last keeps the last good state
                break;
            }
            for (int j = c.tid; j < n; j += c.nt) out[j] = st.y[j];
            pk = ssfm::nan_max(pk, ssfm::block_peak(c, st.y));
        }
        if (ok && rem > 0) {
            st.steps(rem);
            ok = ssfm::block_finite(c, st.y);
        }
    }
    if (c.tid == 0) {
        pk_out[b] = pk;
        ok_out[b] = ok ? 1 : 0;
    }
}

template <typename T>
__device__ Block<T> block_of(const Cx<double>* tw, unsigned char* smem, int n) {
    Block<T> c;
    c.tw = tw;
    c.red = reinterpret_cast<T*>(smem);
    c.n = n;
    ssfm::split(n, &c.m, &c.r);
    c.tid = threadIdx.x;
    c.nt = blockDim.x;
    c.inv_n = 1.0 / n;
    return c;
}

template <typename T, int S>
__global__ void __launch_bounds__(ssfm::Bounds<S, false>::kThreads,
                                  ssfm::Bounds<S, false>::kBlocks)
gnlse_ssfm_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                  const Cx<T>* __restrict__ lf, int fac_stride, const T* __restrict__ gamma,
                  const Cx<double>* __restrict__ tw, T* __restrict__ pk_out,
                  Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out, int n, int n_steps,
                  int save_every, double dz) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    ssfm::Strang<T, S, 1, Kerr<T>> st;
    st.setup(tw, smem, n, lh + static_cast<size_t>(b) * fac_stride,
             lf + static_cast<size_t>(b) * fac_stride);
    st.op = Kerr<T>{gamma[b], T(dz)};
    st.run(y0, pk_out, y_last, ok_out, n_steps, save_every);
}

// Blocks an SM the nl kernel asks registers for: two (at most 128 registers
// a thread at 256 threads; the stepper, its sums and a radix-4 butterfly
// fit without spilling up to 4 slots), one at 8 slots (n > 1,024), whose
// sums would spill under 128.
template <typename T, int S>
__global__ void __launch_bounds__(ssfm::kMaxThreads, S == 8 ? 1 : 2)
gnlse_nl_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                const Cx<T>* __restrict__ lf, int fac_stride, const T* __restrict__ gamma,
                const Cx<double>* __restrict__ tw, const Cx<T>* __restrict__ hrc,
                const T* __restrict__ omega, T* __restrict__ pk_out,
                Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out, int n, int n_steps,
                int save_every, double dz, double f_r, double inv_w0) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    NlStepper<T, S> st;
    st.c = block_of<T>(tw, smem, n);
    st.full = ssfm::plan(tw, n, 1, st.c.tid, st.c.nt);
    st.half = ssfm::plan(tw, n, 2, st.c.tid, st.c.nt);
    Cx<T>* buf = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
    st.y = buf;
    st.b1 = buf + n;
    st.b2 = buf + 2 * n;
    st.lh = lh + static_cast<size_t>(b) * fac_stride;
    st.lf = lf + static_cast<size_t>(b) * fac_stride;
    st.hrc = hrc;
    st.omega = omega;
    st.g = gamma[b];
    st.h = T(dz);
    st.fr = T(f_r);
    st.one_m_fr = T(1) - st.fr;
    st.inv_w0 = T(inv_w0);
    st.raman = f_r > 0.0;
    st.steep = inv_w0 != 0.0;
    integrate<T>(st, y0, pk_out, y_last, ok_out, n_steps, save_every);
}

size_t shared_bytes(int n, size_t elem, int use_nl) {
    const size_t buffers = use_nl ? kNlBuffers : kKerrBuffers;
    return elem * (kReduceSlots + 2 * buffers * static_cast<size_t>(n));
}

// Slots a thread of the nl kernel: ceil(n / threads) rounded up to 2, 4 or 8.
int nl_slots(int n) {
    const int nt = ssfm::threads_for(n), need = (n + nt - 1) / nt;
    return need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

template <typename K, typename... Args>
int launch_kernel(K kernel, int B, int nt, size_t smem, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// The Kerr route at the width's block (ssfm::strang_block), with the wide
// launch bounds at every width: one instantiation a slot count (below
// n = 1,024 the block just has fewer threads, as K9's rotation body's).
template <typename T, typename... Args>
int launch_kerr(int B, int n, size_t smem, void* stream, Args... args) {
    int S, passes;
    const int nt = ssfm::strang_block(n, &S, &passes);
    if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (S == 8) return launch_kernel(gnlse_ssfm_kernel<T, 8>, B, nt, smem, stream, args...);
    return launch_kernel(gnlse_ssfm_kernel<T, 4>, B, nt, smem, stream, args...);
}

template <typename T>
int launch(const void* y0, const void* lh, const void* lf, int fac_stride, const void* gamma,
           const void* tw, const void* hrc, const void* omega, void* pk, void* y_last, void* ok,
           int B, int n, int n_steps, int save_every, int use_nl, double dz, double f_r,
           double inv_w0, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T), use_nl);
    const auto* y0_ = static_cast<const Cx<T>*>(y0);
    const auto* lh_ = static_cast<const Cx<T>*>(lh);
    const auto* lf_ = static_cast<const Cx<T>*>(lf);
    const auto* g_ = static_cast<const T*>(gamma);
    const auto* tw_ = static_cast<const Cx<double>*>(tw);
    auto* pk_ = static_cast<T*>(pk);
    auto* yl_ = static_cast<Cx<T>*>(y_last);
    auto* ok_ = static_cast<uint8_t*>(ok);
    if (!use_nl)
        return launch_kerr<T>(B, n, smem, stream, y0_, lh_, lf_, fac_stride, g_, tw_, pk_, yl_,
                              ok_, n, n_steps, save_every, dz);
    const int nt = ssfm::threads_for(n);
    const auto* hrc_ = static_cast<const Cx<T>*>(hrc);
    const auto* om_ = static_cast<const T*>(omega);
    switch (nl_slots(n)) {
        case 2:
            return launch_kernel(gnlse_nl_kernel<T, 2>, B, nt, smem, stream, y0_, lh_, lf_,
                                 fac_stride, g_, tw_, hrc_, om_, pk_, yl_, ok_, n, n_steps,
                                 save_every, dz, f_r, inv_w0);
        case 4:
            return launch_kernel(gnlse_nl_kernel<T, 4>, B, nt, smem, stream, y0_, lh_, lf_,
                                 fac_stride, g_, tw_, hrc_, om_, pk_, yl_, ok_, n, n_steps,
                                 save_every, dz, f_r, inv_w0);
        default:
            return launch_kernel(gnlse_nl_kernel<T, 8>, B, nt, smem, stream, y0_, lh_, lf_,
                                 fac_stride, g_, tw_, hrc_, om_, pk_, yl_, ok_, n, n_steps,
                                 save_every, dz, f_r, inv_w0);
    }
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" int gnlse_ssfm_shared_bytes(int n, int elem, int use_nl) {
    return static_cast<int>(shared_bytes(n, static_cast<size_t>(elem), use_nl));
}

// The Kerr route's block at width n: its threads, samples a thread and
// passes a transform (ssfm::strang_block).
extern "C" int gnlse_ssfm_strang_block(int n, int* slots, int* passes) {
    return ssfm::strang_block(n, slots, passes);
}

#define GNLSE_SSFM_LAUNCHER(NAME, T)                                                             \
    extern "C" int NAME(const void* y0, const void* lh, const void* lf, int fac_stride,          \
                        const void* gamma, const void* tw, const void* hrc, const void* omega,   \
                        void* pk, void* y_last, void* ok, int B, int n, int n_steps,             \
                        int save_every, int use_nl, double dz, double f_r, double inv_w0,        \
                        void* stream) {                                                          \
        return launch<T>(y0, lh, lf, fac_stride, gamma, tw, hrc, omega, pk, y_last, ok, B, n, \
                         n_steps, save_every, use_nl, dz, f_r, inv_w0, stream);                 \
    }

GNLSE_SSFM_LAUNCHER(gnlse_ssfm_f64, double)
GNLSE_SSFM_LAUNCHER(gnlse_ssfm_f32, float)
