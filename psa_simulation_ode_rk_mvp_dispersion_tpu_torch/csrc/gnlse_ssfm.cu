// Batched fixed-step GNLSE integration by the symmetric (Strang) split-step
// Fourier method, one CUDA thread block per envelope, the whole integration
// in one launch.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_gnlse.py::_kernel_body   (K6, the fused GNLSE SSFM kernel)
// and its affine build driven by ops/pallas_lle.py (K7, the LLE cavity)
// with one template, gnlse_ssfm_kernel<T, Affine>, T in {double, float}:
// float64 serves x64/df32, float32 serves x32; Affine false is K6, true K7.
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
//   - Affine (K7, the contract of models/lle.lle_fixed with method
//     'strang', which ops/cuda_lle.solve_lle_batch_torch runs): gamma = 1,
//     no nonlinear terms, L = exp((-1 + i phi_d) s), and each linear
//     substep ends with the affine write y <- y dp + dF, the detuning
//     rotation dp = exp(-i Delta s) and the drive offset
//     dF = F (e^{Lam0 s} - 1)/Lam0, Lam0 = -(1 + i Delta), of the cavity
//     for s = dz/2 (with Lh) or dz (with Lf), which the wrapper builds in
//     float64; a separate pointwise pass over shared memory;
//   - ok starts as "y0 is finite"; after each chunk a non-finite state
//     clears ok and the envelope keeps its last good state (which it then
//     keeps for good: the rest of the run cannot change its outputs, so the
//     block stops); otherwise the state is saved and the peak, the running
//     max over saved samples of max_t |y|^2 (from y0, NaN propagating),
//     grows; the trailing n_steps % save_every steps are integrated from the
//     last saved state and feed only ok.
//
// What bounds it: arithmetic.  A Kerr step is one transform pair (about
// 10 n log2 n flop) and O(n) pointwise work on a state of n samples; an nl
// step adds four evaluations of N, each two or four more transforms.  The
// state lives in shared memory for the whole integration; each envelope
// reads its input once and writes its outputs (and its saved state, once a
// chunk) to device memory.  The transforms are csrc/ssfm_common.cuh's own
// radix-2 Stockham passes; the linear factors, the twiddles, conj(H_R) and
// omega are read from device memory through the read-only cache, so that
// the shared memory holds only state-sized buffers: 2 of them for Kerr, 7
// for nl (y, its transform partner, the RK4 sums k1 + 2(k2 + k3) and
// k2 + k3, the current derivative, the stage input, a second transform
// scratch).  At n = 2048 in fp64 that is 229,632 bytes, inside the 232,448 a
// Hopper block may use.
//
// Global layout (row-major, one row per envelope, complex as (re, im)):
//   y0 (B, n); lh, lf (n,) with fac_stride 0 or (B, n) with fac_stride n;
//   gamma (B,); tw (n,) = (cos, sin)(2 pi k / n) in float64; hrc (n,) = conj(H_R);
//   omega (n,); Affine: aff (B, 4) complex = (dp_h, dF_h, dp_f, dF_f), gamma,
//   hrc and omega unread; outputs peak (B,), y_last (B, n), ok (B,) uint8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" functions at the end; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssfm_common.cuh"

namespace {

using ssfm::Block;
using ssfm::Cx;
using ssfm::dft;

constexpr int kKerrBuffers = 2;
constexpr int kNlBuffers = 7;
constexpr int kReduceSlots = 32;

// One envelope's integration: its buffers, factors and coefficients.
template <typename T, bool Affine>
struct Stepper {
    Block<T> c;
    Cx<T>*y, *x;                 // the state and its transform partner
    Cx<T>*a, *s, *k, *st, *q;    // nl only
    const Cx<T>*lh, *lf;
    const Cx<T>* hrc;
    const T* omega;
    T g, h, one_m_fr, fr, inv_w0;
    bool use_nl, raman, steep;
    Cx<T> dp_h, dF_h, dp_f, dF_f;  // Affine only

    // y <- IDFT(L * DFT(y)), then, Affine, y <- y dp + dF.
    __device__ void lin(const Cx<T>* L, const Cx<T>& dp, const Cx<T>& dF) {
        Cx<T>* f = dft<T, false>(c, y, x);
        Cx<T>* o = f == y ? x : y;
        ssfm::mul_factor(c, f, L);
        Cx<T>* r = dft<T, true>(c, f, o);
        x = r == f ? o : f;
        y = r;
        if constexpr (Affine) ssfm::affine(c, y, dp, dF);
    }

    // dst = N(src) (models/gnlse._nl_rhs); p and the block's q are scratch.
    __device__ void nl_rhs(const Cx<T>* src, Cx<T>* dst, Cx<T>* p) {
        const int n = c.n;
        Cx<T>* R = nullptr;  // its real parts: the Raman response
        Cx<T>* free = p;
        __syncthreads();
        if (raman) {
            for (int j = c.tid; j < n; j += c.nt) {
                const Cx<T> v = src[j];
                p[j] = Cx<T>{v.re * v.re + v.im * v.im, T(0)};
            }
            Cx<T>* f = dft<T, false>(c, p, q);
            ssfm::mul_factor(c, f, hrc);
            R = dft<T, true>(c, f, f == p ? q : p);
            free = R == p ? q : p;
        }
        for (int j = c.tid; j < n; j += c.nt) {
            const Cx<T> v = src[j];
            const T P = v.re * v.re + v.im * v.im;
            const T fac = raman ? one_m_fr * P + fr * R[j].re : one_m_fr * P;
            const Cx<T> W{v.re * fac, v.im * fac};
            if (steep) {
                dst[j] = W;
                free[j] = W;
            } else {
                dst[j] = Cx<T>{-(g * W.im), g * W.re};
            }
        }
        if (!steep) return;
        Cx<T>* other = free == p ? q : p;
        Cx<T>* f = dft<T, false>(c, free, other);
        for (int j = c.tid; j < n; j += c.nt) {
            const Cx<T> F = f[j];
            const T om = omega[j];
            f[j] = Cx<T>{-(om * F.im), om * F.re};  // i omega F
        }
        const Cx<T>* V = dft<T, true>(c, f, f == free ? other : free);  // dW/dt
        for (int j = c.tid; j < n; j += c.nt) {
            const Cx<T> W = dst[j], v = V[j];
            const T ir = W.re - inv_w0 * (-v.im);  // W - (1/omega_0) i dW/dt
            const T ii = W.im - inv_w0 * v.re;
            dst[j] = Cx<T>{-(g * ii), g * ir};
        }
    }

    // One nonlinear substep of length h on y.
    __device__ void nl() {
        if (!use_nl) {
            ssfm::kerr(c, y, g, h);
            return;
        }
        const int n = c.n;
        const T half = T(0.5) * h, sixth = h / T(6);
        nl_rhs(y, a, x);  // k1
        for (int j = c.tid; j < n; j += c.nt)
            st[j] = Cx<T>{y[j].re + half * a[j].re, y[j].im + half * a[j].im};
        nl_rhs(st, s, x);  // k2
        for (int j = c.tid; j < n; j += c.nt)
            st[j] = Cx<T>{y[j].re + half * s[j].re, y[j].im + half * s[j].im};
        nl_rhs(st, k, x);  // k3
        for (int j = c.tid; j < n; j += c.nt) {
            const Cx<T> s23{s[j].re + k[j].re, s[j].im + k[j].im};
            st[j] = Cx<T>{y[j].re + h * k[j].re, y[j].im + h * k[j].im};
            a[j] = Cx<T>{a[j].re + T(2) * s23.re, a[j].im + T(2) * s23.im};
        }
        nl_rhs(st, k, x);  // k4
        for (int j = c.tid; j < n; j += c.nt)
            y[j] = Cx<T>{y[j].re + sixth * (a[j].re + k[j].re),
                         y[j].im + sixth * (a[j].im + k[j].im)};
    }

    // k fused symmetric steps: Lh, (NL, Lf)^(k-1), NL, Lh.
    __device__ void steps(int kk) {
        lin(lh, dp_h, dF_h);
        for (int i = 1; i < kk; ++i) {
            nl();
            lin(lf, dp_f, dF_f);
        }
        nl();
        lin(lh, dp_h, dF_h);
    }
};

template <typename T, bool Affine>
__global__ void __launch_bounds__(ssfm::kMaxThreads)
gnlse_ssfm_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                  const Cx<T>* __restrict__ lf, int fac_stride, const T* __restrict__ gamma,
                  const Cx<T>* __restrict__ aff, const Cx<double>* __restrict__ tw,
                  const Cx<T>* __restrict__ hrc, const T* __restrict__ omega,
                  T* __restrict__ pk_out, Cx<T>* __restrict__ y_last,
                  uint8_t* __restrict__ ok_out, int n, int n_steps, int save_every, int use_nl,
                  double dz, double f_r, double inv_w0) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    Stepper<T, Affine> st;
    st.c.tw = tw;
    st.c.red = reinterpret_cast<T*>(smem);
    st.c.n = n;
    ssfm::split(n, &st.c.m, &st.c.r);
    st.c.tid = threadIdx.x;
    st.c.nt = blockDim.x;
    st.c.inv_n = 1.0 / n;
    Cx<T>* buf = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
    st.y = buf;
    st.x = buf + n;
    st.a = buf + 2 * n;
    st.s = buf + 3 * n;
    st.k = buf + 4 * n;
    st.st = buf + 5 * n;
    st.q = buf + 6 * n;
    st.lh = lh + static_cast<size_t>(b) * fac_stride;
    st.lf = lf + static_cast<size_t>(b) * fac_stride;
    st.hrc = hrc;
    st.omega = omega;
    if constexpr (Affine) {
        st.g = T(1);
        const Cx<T>* a = aff + 4 * static_cast<size_t>(b);
        st.dp_h = a[0];
        st.dF_h = a[1];
        st.dp_f = a[2];
        st.dF_f = a[3];
    } else {
        st.g = gamma[b];
    }
    st.h = T(dz);
    st.fr = T(f_r);
    st.one_m_fr = T(1) - st.fr;
    st.inv_w0 = T(inv_w0);
    st.use_nl = use_nl != 0;
    st.raman = st.use_nl && f_r > 0.0;
    st.steep = st.use_nl && inv_w0 != 0.0;
    const Block<T>& c = st.c;

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

size_t shared_bytes(int n, size_t elem, int use_nl) {
    const size_t buffers = use_nl ? kNlBuffers : kKerrBuffers;
    return elem * (kReduceSlots + 2 * buffers * static_cast<size_t>(n));
}

template <typename T, bool Affine>
int launch(const void* y0, const void* lh, const void* lf, int fac_stride, const void* gamma,
           const void* aff, const void* tw, const void* hrc, const void* omega, void* pk,
           void* y_last, void* ok, int B, int n, int n_steps, int save_every, int use_nl,
           double dz, double f_r, double inv_w0, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T), use_nl);
    cudaError_t err = cudaFuncSetAttribute(gnlse_ssfm_kernel<T, Affine>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gnlse_ssfm_kernel<T, Affine>
        <<<B, ssfm::threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const Cx<T>*>(y0), static_cast<const Cx<T>*>(lh),
            static_cast<const Cx<T>*>(lf), fac_stride, static_cast<const T*>(gamma),
            static_cast<const Cx<T>*>(aff), static_cast<const Cx<double>*>(tw),
            static_cast<const Cx<T>*>(hrc), static_cast<const T*>(omega), static_cast<T*>(pk),
            static_cast<Cx<T>*>(y_last), static_cast<uint8_t*>(ok), n, n_steps, save_every,
            use_nl, dz, f_r, inv_w0);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" int gnlse_ssfm_shared_bytes(int n, int elem, int use_nl) {
    return static_cast<int>(shared_bytes(n, static_cast<size_t>(elem), use_nl));
}

#define GNLSE_SSFM_LAUNCHER(NAME, T)                                                             \
    extern "C" int NAME(const void* y0, const void* lh, const void* lf, int fac_stride,          \
                        const void* gamma, const void* tw, const void* hrc, const void* omega,   \
                        void* pk, void* y_last, void* ok, int B, int n, int n_steps,             \
                        int save_every, int use_nl, double dz, double f_r, double inv_w0,        \
                        void* stream) {                                                          \
        return launch<T, false>(y0, lh, lf, fac_stride, gamma, nullptr, tw, hrc, omega, pk,     \
                                y_last, ok, B, n, n_steps, save_every, use_nl, dz, f_r, inv_w0, \
                                stream);                                                        \
    }

GNLSE_SSFM_LAUNCHER(gnlse_ssfm_f64, double)
GNLSE_SSFM_LAUNCHER(gnlse_ssfm_f32, float)

// The LLE (K7): the affine instantiation, Kerr only, unit gamma.
#define LLE_SSFM_LAUNCHER(NAME, T)                                                               \
    extern "C" int NAME(const void* y0, const void* lh, const void* lf, int fac_stride,          \
                        const void* aff, const void* tw, void* pk, void* y_last, void* ok,       \
                        int B, int n, int n_steps, int save_every, double dt, void* stream) {    \
        return launch<T, true>(y0, lh, lf, fac_stride, nullptr, aff, tw, nullptr, nullptr, pk,  \
                               y_last, ok, B, n, n_steps, save_every, 0, dt, 0.0, 0.0, stream); \
    }

LLE_SSFM_LAUNCHER(lle_ssfm_f64, double)
LLE_SSFM_LAUNCHER(lle_ssfm_f32, float)
