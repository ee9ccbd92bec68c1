// Batched fixed-step vector (two-polarization) GNLSE integration by the
// symmetric (Strang) split-step Fourier method, one CUDA thread block per
// instance, the whole integration in one launch.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_vgnlse.py::_kernel_body   (K9, the fused vector SSFM kernel)
// with one template, vgnlse_ssfm_kernel<T, Body>, T in {double, float}:
// float64 serves x64/df32, float32 serves x32.  It computes what the JAX
// package's scan computes (models/vgnlse._vgnlse_solver), which the port's
// plain version ops/cuda_vgnlse.solve_vgnlse_batch_torch runs:
//   - the state is both polarizations of one instance, y[p*n + j];
//   - every save chunk of k steps is Lh, (NL, Lf)^(k-1), NL, Lh, with the
//     linear substep y_p <- IDFT(L_p * DFT(y_p)) and L = Lh or Lf the
//     factors exp((-alpha/2 + i phi_p) h) for h = dz/2 and h = dz (each
//     built for its own h, as the scan builds them; the TPU kernel squares
//     Lh), which the wrapper builds with the plain version's own function,
//     one (2, n) plane shared by every instance or one an instance;
//   - NL, by Body:
//       kRotation: the exact joint rotation y_p exp(i gamma (P_p + b P_q) dz),
//         the angle reading both polarizations' powers at the same sample
//         (the cnlse and manakov couplings);
//       kCoherent: one RK4 step of N_p = i gamma [(P_p + b P_q) y_p
//         + c y_p* y_q^2] (coupling 'isotropic'), pointwise: each thread
//         keeps a sample's four stages of both polarizations in registers;
//       kNl: one RK4 step of the isotropic-Raman operator
//           W_p = (1 - f_R) K_p + f_R y_p Re IDFT(conj(H_R) DFT(P_x + P_y)),
//           N_p = i gamma (W_p - (i/omega_0) IDFT(i omega DFT(W_p))),
//         K_p the coupling term above (c = 0 but for 'isotropic'): one
//         transform pair on the total power, then one pair per polarization
//         for the shock term; the Raman pair drops out when f_R = 0 and the
//         shock pairs when 1/omega_0 = 0;
//   - ok starts as "y0 is finite" (both polarizations; the TPU kernel starts
//     it from ones); after each chunk a non-finite state clears ok and the
//     instance keeps its last saved state for good (the block stops);
//     otherwise the state is saved and each polarization's peak, the running
//     max over saved samples of max_t |y_p|^2 (NaN propagating), grows; the
//     trailing n_steps % save_every steps are integrated from the last saved
//     state and feed only ok.
//
// What bounds it: arithmetic and the barriers between transform passes.  A
// step is two transform pairs (one a polarization) and O(n) pointwise work;
// the state stays in shared memory for the whole integration, and each
// instance reads its input once and writes its outputs (and its saved state
// once a chunk).  The two polarizations go through each transform in the
// same radix-2 passes (csrc/ssfm_common.cuh, dft<T, INV, 2>), so a pass
// costs one barrier for the pair, with twice K6's butterflies a barrier.
// The factor planes, the twiddles, conj(H_R) and omega are read through the
// read-only cache; shared memory holds only state-sized buffers of 2n
// samples: y and its transform partner x (rotation, coherent), plus the RK4
// sums a, s, k, the stage input st and the scratch q (nl): 4 or 14 buffers
// of n complex values.  The nl block at n = 1024 in fp64 takes 229,632
// bytes, inside the 232,448 a Hopper block may use; at n = 2048 it fits in
// fp32 only (ops/cuda_vgnlse.width_problem refuses the rest).
//
// Global layout (row-major, complex as (re, im)):
//   y0 (B, 2, n); lh, lf (2, n) with fac_stride 0 or (B, 2, n) with
//   fac_stride 2n; gamma (B,); tw (n,) = (cos, sin)(2 pi k / n) in float64;
//   hrc (n,) = conj(H_R); omega (n,); outputs peak (B, 2), y_last (B, 2, n),
//   ok (B,) uint8.
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

enum Body { kRotation = 0, kCoherent = 1, kNl = 2 };

constexpr int kPols = 2;
constexpr int kRotationBuffers = 4;  // y and x, two polarizations each
constexpr int kNlBuffers = 14;       // y, x, a, s, k, st, q
constexpr int kReduceSlots = 32;

template <typename T>
__device__ inline Cx<T> cmul(const Cx<T>& a, const Cx<T>& b) {
    return Cx<T>{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// K_p = (P_p + b P_q) u_p + c conj(u_p) u_q^2 at one sample, for p = the
// polarization of u and q that of v, in the plain version's order.
template <typename T>
__device__ inline Cx<T> coupling(const Cx<T>& u, const Cx<T>& v, T b, T c, bool coherent) {
    const T Pu = u.re * u.re + u.im * u.im, Pv = v.re * v.re + v.im * v.im;
    const T s = Pu + b * Pv;
    Cx<T> K{s * u.re, s * u.im};
    if (coherent) {
        const Cx<T> t = cmul(cmul(Cx<T>{u.re, -u.im}, v), v);
        K = Cx<T>{K.re + c * t.re, K.im + c * t.im};
    }
    return K;
}

// i g K.
template <typename T>
__device__ inline Cx<T> times_ig(const Cx<T>& K, T g) {
    return Cx<T>{-(g * K.im), g * K.re};
}

// One instance's integration: its buffers, factors and coefficients.
template <typename T, int Body>
struct Stepper {
    Block<T> c;    // n: one polarization's samples
    Block<T> c2;   // the same block over both polarizations (n = 2 * c.n)
    Cx<T>*y, *x;                // the state and its transform partner, 2n each
    Cx<T>*a, *s, *k, *st, *q;   // nl only
    const Cx<T>*lh, *lf;
    const Cx<T>* hrc;
    const T* omega;
    T g, h, b, coh, one_m_fr, fr, inv_w0;
    bool raman, steep;

    // y_p <- IDFT(L_p * DFT(y_p)) for both polarizations.
    __device__ void lin(const Cx<T>* L) {
        Cx<T>* f = dft<T, false, kPols>(c, y, x);
        Cx<T>* o = f == y ? x : y;
        ssfm::mul_factor(c2, f, L);
        Cx<T>* r = dft<T, true, kPols>(c, f, o);
        x = r == f ? o : f;
        y = r;
    }

    // The exact joint rotation over dz.
    __device__ void rotation() {
        const int n = c.n;
        __syncthreads();
        for (int j = c.tid; j < n; j += c.nt) {
            const Cx<T> u = y[j], v = y[n + j];
            const T Pu = u.re * u.re + u.im * u.im, Pv = v.re * v.re + v.im * v.im;
            const T au = (g * (Pu + b * Pv)) * h, av = (g * (Pv + b * Pu)) * h;
            T su, cu, sv, cv;
            ssfm::sin_cos(au, &su, &cu);
            ssfm::sin_cos(av, &sv, &cv);
            y[j] = Cx<T>{u.re * cu - u.im * su, u.re * su + u.im * cu};
            y[n + j] = Cx<T>{v.re * cv - v.im * sv, v.re * sv + v.im * cv};
        }
    }

    // One RK4 step of the coherent operator over dz, a sample at a time in
    // registers.
    __device__ void coherent_rk4() {
        const int n = c.n;
        const T half = T(0.5) * h, sixth = h / T(6);
        __syncthreads();
        for (int j = c.tid; j < n; j += c.nt) {
            const Cx<T> u = y[j], v = y[n + j];
            const Cx<T> k1u = times_ig(coupling(u, v, b, coh, true), g);
            const Cx<T> k1v = times_ig(coupling(v, u, b, coh, true), g);
            Cx<T> su{u.re + half * k1u.re, u.im + half * k1u.im};
            Cx<T> sv{v.re + half * k1v.re, v.im + half * k1v.im};
            const Cx<T> k2u = times_ig(coupling(su, sv, b, coh, true), g);
            const Cx<T> k2v = times_ig(coupling(sv, su, b, coh, true), g);
            su = Cx<T>{u.re + half * k2u.re, u.im + half * k2u.im};
            sv = Cx<T>{v.re + half * k2v.re, v.im + half * k2v.im};
            const Cx<T> k3u = times_ig(coupling(su, sv, b, coh, true), g);
            const Cx<T> k3v = times_ig(coupling(sv, su, b, coh, true), g);
            su = Cx<T>{u.re + h * k3u.re, u.im + h * k3u.im};
            sv = Cx<T>{v.re + h * k3v.re, v.im + h * k3v.im};
            const Cx<T> k4u = times_ig(coupling(su, sv, b, coh, true), g);
            const Cx<T> k4v = times_ig(coupling(sv, su, b, coh, true), g);
            const Cx<T> au{k1u.re + T(2) * (k2u.re + k3u.re), k1u.im + T(2) * (k2u.im + k3u.im)};
            const Cx<T> av{k1v.re + T(2) * (k2v.re + k3v.re), k1v.im + T(2) * (k2v.im + k3v.im)};
            y[j] = Cx<T>{u.re + sixth * (au.re + k4u.re), u.im + sixth * (au.im + k4u.im)};
            y[n + j] = Cx<T>{v.re + sixth * (av.re + k4v.re), v.im + sixth * (av.im + k4v.im)};
        }
    }

    // dst = N(src) over both polarizations (models/vgnlse._v_nl_rhs_gen);
    // x and q are scratch.
    __device__ void nl_rhs(const Cx<T>* src, Cx<T>* dst) {
        const int n = c.n;
        const bool cterm = coh != T(0);
        const Cx<T>* R = nullptr;  // its real parts: the Raman response
        __syncthreads();
        if (raman) {
            Cx<T>* p = x;
            Cx<T>* p2 = x + n;
            for (int j = c.tid; j < n; j += c.nt) {
                const Cx<T> u = src[j], v = src[n + j];
                p[j] = Cx<T>{(u.re * u.re + u.im * u.im) + (v.re * v.re + v.im * v.im), T(0)};
            }
            Cx<T>* f = dft<T, false>(c, p, p2);
            ssfm::mul_factor(c, f, hrc);
            R = dft<T, true>(c, f, f == p ? p2 : p);
        }
        for (int j = c.tid; j < n; j += c.nt) {
            const Cx<T> u = src[j], v = src[n + j];
            const Cx<T> Ku = coupling(u, v, b, coh, cterm), Kv = coupling(v, u, b, coh, cterm);
            Cx<T> Wu{one_m_fr * Ku.re, one_m_fr * Ku.im}, Wv{one_m_fr * Kv.re, one_m_fr * Kv.im};
            if (raman) {
                const T Rj = R[j].re;
                Wu = Cx<T>{Wu.re + fr * (Rj * u.re), Wu.im + fr * (Rj * u.im)};
                Wv = Cx<T>{Wv.re + fr * (Rj * v.re), Wv.im + fr * (Rj * v.im)};
            }
            if (steep) {
                dst[j] = Wu;
                dst[n + j] = Wv;
                q[j] = Wu;
                q[n + j] = Wv;
            } else {
                dst[j] = times_ig(Wu, g);
                dst[n + j] = times_ig(Wv, g);
            }
        }
        if (steep) {
            Cx<T>* f = dft<T, false, kPols>(c, q, x);  // the Raman response is used up
            for (int j = c.tid; j < 2 * n; j += c.nt) {
                const Cx<T> F = f[j];
                const T om = omega[j < n ? j : j - n];
                f[j] = Cx<T>{-(om * F.im), om * F.re};  // i omega F
            }
            const Cx<T>* V = dft<T, true, kPols>(c, f, f == q ? x : q);  // dW/dt
            for (int j = c.tid; j < 2 * n; j += c.nt) {
                const Cx<T> W = dst[j], v = V[j];
                // W - (1/omega_0) i dW/dt
                dst[j] = times_ig(Cx<T>{W.re - inv_w0 * (-v.im), W.im - inv_w0 * v.re}, g);
            }
        }
        __syncthreads();  // dst complete for the stage loops, which stride over 2n
    }

    // One RK4 step of the generalized operator over dz.
    __device__ void nl_rk4() {
        const int n2 = 2 * c.n;
        const T half = T(0.5) * h, sixth = h / T(6);
        nl_rhs(y, a);  // k1
        for (int j = c.tid; j < n2; j += c.nt)
            st[j] = Cx<T>{y[j].re + half * a[j].re, y[j].im + half * a[j].im};
        nl_rhs(st, s);  // k2
        for (int j = c.tid; j < n2; j += c.nt)
            st[j] = Cx<T>{y[j].re + half * s[j].re, y[j].im + half * s[j].im};
        nl_rhs(st, k);  // k3
        for (int j = c.tid; j < n2; j += c.nt) {
            const Cx<T> s23{s[j].re + k[j].re, s[j].im + k[j].im};
            st[j] = Cx<T>{y[j].re + h * k[j].re, y[j].im + h * k[j].im};
            a[j] = Cx<T>{a[j].re + T(2) * s23.re, a[j].im + T(2) * s23.im};
        }
        nl_rhs(st, k);  // k4
        for (int j = c.tid; j < n2; j += c.nt)
            y[j] = Cx<T>{y[j].re + sixth * (a[j].re + k[j].re),
                         y[j].im + sixth * (a[j].im + k[j].im)};
    }

    __device__ void nl() {
        if constexpr (Body == kRotation) {
            rotation();
        } else if constexpr (Body == kCoherent) {
            coherent_rk4();
        } else {
            nl_rk4();
        }
    }

    // k fused symmetric steps: Lh, (NL, Lf)^(k-1), NL, Lh.
    __device__ void steps(int kk) {
        lin(lh);
        for (int i = 1; i < kk; ++i) {
            nl();
            lin(lf);
        }
        nl();
        lin(lh);
    }
};

template <typename T, int Body>
__global__ void __launch_bounds__(ssfm::kMaxThreads)
vgnlse_ssfm_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                   const Cx<T>* __restrict__ lf, int fac_stride, const T* __restrict__ gamma,
                   const Cx<double>* __restrict__ tw, const Cx<T>* __restrict__ hrc,
                   const T* __restrict__ omega, T* __restrict__ pk_out,
                   Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out, int n, int n_steps,
                   int save_every, double dz, double b, double coherent, double f_r,
                   double inv_w0) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int bi = blockIdx.x;
    const int n2 = kPols * n;
    Stepper<T, Body> st;
    st.c.tw = tw;
    st.c.red = reinterpret_cast<T*>(smem);
    st.c.n = n;
    ssfm::split(n, &st.c.m, &st.c.r);
    st.c.tid = threadIdx.x;
    st.c.nt = blockDim.x;
    st.c.inv_n = 1.0 / n;
    st.c2 = st.c;
    st.c2.n = n2;
    Cx<T>* buf = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
    st.y = buf;
    st.x = buf + n2;
    st.a = buf + 2 * n2;
    st.s = buf + 3 * n2;
    st.k = buf + 4 * n2;
    st.st = buf + 5 * n2;
    st.q = buf + 6 * n2;
    st.lh = lh + static_cast<size_t>(bi) * fac_stride;
    st.lf = lf + static_cast<size_t>(bi) * fac_stride;
    st.hrc = hrc;
    st.omega = omega;
    st.g = gamma[bi];
    st.h = T(dz);
    st.b = T(b);
    st.coh = T(coherent);
    st.fr = T(f_r);
    st.one_m_fr = T(1) - st.fr;
    st.inv_w0 = T(inv_w0);
    st.raman = Body == kNl && f_r > 0.0;
    st.steep = Body == kNl && inv_w0 != 0.0;
    const Block<T>& c = st.c;

    Cx<T>* out = y_last + static_cast<size_t>(bi) * n2;
    for (int j = c.tid; j < n2; j += c.nt) {
        const Cx<T> v = y0[static_cast<size_t>(bi) * n2 + j];
        st.y[j] = v;
        out[j] = v;
    }
    bool ok = ssfm::block_finite(st.c2, st.y);
    T pk0 = ssfm::block_peak(c, st.y);
    T pk1 = ssfm::block_peak(c, st.y + n);
    const int n_chunks = n_steps / save_every, rem = n_steps - n_chunks * save_every;
    if (ok) {
        for (int i = 0; i < n_chunks; ++i) {
            st.steps(save_every);
            if (!ssfm::block_finite(st.c2, st.y)) {
                ok = false;  // y_last keeps the last saved state
                break;
            }
            for (int j = c.tid; j < n2; j += c.nt) out[j] = st.y[j];
            pk0 = ssfm::nan_max(pk0, ssfm::block_peak(c, st.y));
            pk1 = ssfm::nan_max(pk1, ssfm::block_peak(c, st.y + n));
        }
        if (ok && rem > 0) {
            st.steps(rem);
            ok = ssfm::block_finite(st.c2, st.y);
        }
    }
    if (c.tid == 0) {
        pk_out[kPols * bi] = pk0;
        pk_out[kPols * bi + 1] = pk1;
        ok_out[bi] = ok ? 1 : 0;
    }
}

size_t shared_bytes(int n, size_t elem, int body) {
    const size_t buffers = body == kNl ? kNlBuffers : kRotationBuffers;
    return elem * (kReduceSlots + 2 * buffers * static_cast<size_t>(n));
}

// Threads a block: half the samples of both polarizations, at most
// ssfm::kMaxThreads (2n is a multiple of 256).
int threads_for(int n) { return ssfm::threads_for(kPols * n); }

template <typename T, int Body>
int launch(const void* y0, const void* lh, const void* lf, int fac_stride, const void* gamma,
           const void* tw, const void* hrc, const void* omega, void* pk, void* y_last, void* ok,
           int B, int n, int n_steps, int save_every, double dz, double b, double coherent,
           double f_r, double inv_w0, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T), Body);
    cudaError_t err = cudaFuncSetAttribute(vgnlse_ssfm_kernel<T, Body>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    vgnlse_ssfm_kernel<T, Body>
        <<<B, threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const Cx<T>*>(y0), static_cast<const Cx<T>*>(lh),
            static_cast<const Cx<T>*>(lf), fac_stride, static_cast<const T*>(gamma),
            static_cast<const Cx<double>*>(tw), static_cast<const Cx<T>*>(hrc),
            static_cast<const T*>(omega), static_cast<T*>(pk), static_cast<Cx<T>*>(y_last),
            static_cast<uint8_t*>(ok), n, n_steps, save_every, dz, b, coherent, f_r, inv_w0);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_body(int body, const void* y0, const void* lh, const void* lf, int fac_stride,
                const void* gamma, const void* tw, const void* hrc, const void* omega, void* pk,
                void* y_last, void* ok, int B, int n, int n_steps, int save_every, double dz,
                double b, double coherent, double f_r, double inv_w0, void* stream) {
    if (body == kRotation)
        return launch<T, kRotation>(y0, lh, lf, fac_stride, gamma, tw, hrc, omega, pk, y_last,
                                    ok, B, n, n_steps, save_every, dz, b, coherent, f_r, inv_w0,
                                    stream);
    if (body == kCoherent)
        return launch<T, kCoherent>(y0, lh, lf, fac_stride, gamma, tw, hrc, omega, pk, y_last,
                                    ok, B, n, n_steps, save_every, dz, b, coherent, f_r, inv_w0,
                                    stream);
    if (body == kNl)
        return launch<T, kNl>(y0, lh, lf, fac_stride, gamma, tw, hrc, omega, pk, y_last, ok, B,
                              n, n_steps, save_every, dz, b, coherent, f_r, inv_w0, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of dynamic shared memory one block takes (body 0 rotation,
// 1 coherent, 2 nl).
extern "C" int vgnlse_ssfm_shared_bytes(int n, int elem, int body) {
    return static_cast<int>(shared_bytes(n, static_cast<size_t>(elem), body));
}

#define VGNLSE_SSFM_LAUNCHER(NAME, T)                                                            \
    extern "C" int NAME(const void* y0, const void* lh, const void* lf, int fac_stride,          \
                        const void* gamma, const void* tw, const void* hrc, const void* omega,   \
                        void* pk, void* y_last, void* ok, int B, int n, int n_steps,             \
                        int save_every, int body, double dz, double b, double coherent,          \
                        double f_r, double inv_w0, void* stream) {                               \
        return launch_body<T>(body, y0, lh, lf, fac_stride, gamma, tw, hrc, omega, pk, y_last,  \
                              ok, B, n, n_steps, save_every, dz, b, coherent, f_r, inv_w0,      \
                              stream);                                                          \
    }

VGNLSE_SSFM_LAUNCHER(vgnlse_ssfm_f64, double)
VGNLSE_SSFM_LAUNCHER(vgnlse_ssfm_f32, float)
