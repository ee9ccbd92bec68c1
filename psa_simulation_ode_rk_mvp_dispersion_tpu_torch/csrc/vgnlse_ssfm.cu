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
// once a chunk).  The factor planes, the twiddles, conj(H_R) and omega are
// read through the cache; shared memory holds only state-sized buffers of 2n
// samples.
//   - rotation, coherent (vgnlse_ssfm_kernel<T, Op, S>):
//     csrc/strang.cuh's slotted Strang body on the two polarizations, as K6's
//     Kerr route runs it on one: radix-4 slot_fft passes that carry both
//     polarizations (one barrier a pass for the pair), the factor product in
//     the forward transform's last pass, the 1/n and the next substep's NL
//     in the inverse one's, where one thread holds sample k of both
//     polarizations (the joint rotation reads both powers; the coherent RK4
//     keeps the sample's four stages in registers), one fused reduction (one
//     flag, one peak a polarization) at a chunk's end; 10 barriers a step at
//     n = 1,024 (22 with radix-2 passes and separate factor and NL passes).
//     Each polarization goes through the passes with the operations of K6's
//     one, so an empty polarization gives K6's outputs bit for bit.  2
//     buffers of 2n, y and its transform partner.  The factors are read
//     through the read-only cache in the forward transform's last pass, so
//     that at 4 samples a thread two blocks fit an SM (2 polarizations x 4
//     slots x 2 factors in registers cost the second; on an H100 at n =
//     1,024 that block, and one of 8 samples a thread at 128 threads, were
//     1.23-1.37x and 1.01-1.17x slower, PERF.md).  One instantiation a slot
//     count, with the wide launch bounds at every width.
//   - nl (vgnlse_nl_kernel): 3 buffers, y and the transform pair; the RK4
//     sums k1 + 2(k2 + k3) and the stage derivative of both polarizations
//     stay in registers of the thread that owns the sample (force-inlined,
//     as csrc/gnlse_ssfm.cu's; in fp64 above n = 512 a thread owns 8
//     samples of each polarization, at n/8 threads), so that at n = 1,024
//     in fp64 a block takes 98,560 bytes and two blocks fit an SM, not 14
//     buffers' 229,632, and fp64 takes n = 2,048 (196,864 bytes).  The
//     transforms are the wide radix-4 passes of csrc/gnlse_ssfm.cu's nl
//     kernel (ssfm_common.cuh's wide_fft, both polarizations in one pass),
//     the Raman pair transforms the real total power as n/2 complex
//     samples, and the linear factor, the inverse's 1/n and the steepening
//     factor 1 + omega/omega_0 act in the last pass of their transforms.
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

#include "strang.cuh"

namespace {

using ssfm::Block;
using ssfm::Cx;

enum Body { kRotation = 0, kCoherent = 1, kNl = 2 };

constexpr int kPols = 2;
constexpr int kRotationBuffers = 4;  // y and x, two polarizations each (ssfm::Strang)
constexpr int kNlBuffers = 6;        // y and the transform pair
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

// The rotation body's NL: the exact joint rotation over dz at one sample,
// y_p exp(i gamma (P_p + b P_q) dz), the angle in the plain version's order.
template <typename T>
struct Rotation {
    T g, h, b, coh;
    __device__ __forceinline__ Cx<T> end(bool, const Cx<T>& x) const { return x; }
    __device__ __forceinline__ void step(Cx<T> (&a)[kPols]) const {
        const Cx<T> u = a[0], v = a[1];
        const T Pu = u.re * u.re + u.im * u.im, Pv = v.re * v.re + v.im * v.im;
        const T au = (g * (Pu + b * Pv)) * h, av = (g * (Pv + b * Pu)) * h;
        T su, cu, sv, cv;
        ssfm::sin_cos(au, &su, &cu);
        ssfm::sin_cos(av, &sv, &cv);
        a[0] = Cx<T>{u.re * cu - u.im * su, u.re * su + u.im * cu};
        a[1] = Cx<T>{v.re * cv - v.im * sv, v.re * sv + v.im * cv};
    }
};

// The coherent body's NL: one RK4 step of the coherent operator over dz at
// one sample, in the plain version's order.
template <typename T>
struct Coherent {
    T g, h, b, coh;
    __device__ __forceinline__ Cx<T> end(bool, const Cx<T>& x) const { return x; }
    __device__ __forceinline__ void step(Cx<T> (&a)[kPols]) const {
        const T half = T(0.5) * h, sixth = h / T(6);
        const Cx<T> u = a[0], v = a[1];
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
        a[0] = Cx<T>{u.re + sixth * (au.re + k4u.re), u.im + sixth * (au.im + k4u.im)};
        a[1] = Cx<T>{v.re + sixth * (av.re + k4v.re), v.im + sixth * (av.im + k4v.im)};
    }
};

// One instance's nl integration: y in shared memory, the RK4 sums of both
// polarizations in registers (slot i of a thread is sample tid + i nt of
// each polarization, S slots a thread).
template <typename T, int S>
struct NlStepper {
    Block<T> c;             // n: one polarization's samples
    Block<T> c2;            // the same block over both polarizations (n = 2 * c.n)
    ssfm::Plan full, half;  // the n-point transforms; the n/2-point one of a real p
    Cx<T>*y, *b1, *b2;      // the state and the transform pair, 2n each (a permutation)
    const Cx<T>*lh, *lf;
    const Cx<T>* hrc;
    const T* omega;
    T g, h, b, coh, one_m_fr, fr, inv_w0;
    bool raman, steep;
    // k1, then k1 + 2(k2 + k3); k2, then the k4 stage input; [polarization][slot]
    Cx<T> a[kPols][S], s[kPols][S];

    __device__ __forceinline__ int at(int i) const { return c.tid + i * c.nt; }

    // y_p <- IDFT(L_p * DFT(y_p)), L applied in the forward transform's last pass.
    __device__ __forceinline__ void lin(const Cx<T>* L) {
        Cx<T>* f = ssfm::wide_fft<T, false, kPols, S>(full, y, b1, ssfm::MulBy<T>{L, c.n});
        Cx<T>* r =
            ssfm::wide_fft<T, true, kPols, S>(full, f, f == y ? b1 : y, ssfm::Scale{c.inv_n});
        if (r != y) {
            b1 = y;
            y = r;
        }
    }

    // out(i, N_x, N_y) for each slot i, the stage input in(i, u, v)
    // (models/vgnlse._v_nl_rhs_gen).
    template <class In, class Out>
    __device__ __forceinline__ void stage(const In& in, const Out& out) {
        const int n = c.n;
        const bool cterm = coh != T(0);
        const T* R = nullptr;  // the Raman response on the total power, n reals
        __syncthreads();       // the last stage's reads of b1 and b2 are done
        if (raman) {
            T* p = reinterpret_cast<T*>(b1);
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const int j = at(i);
                if (j < n) {
                    Cx<T> u, v;
                    in(i, u, v);
                    p[j] = (u.re * u.re + u.im * u.im) + (v.re * v.re + v.im * v.im);
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
                Cx<T> u, v;
                in(i, u, v);
                const Cx<T> Ku = coupling(u, v, b, coh, cterm), Kv = coupling(v, u, b, coh, cterm);
                Cx<T> Wu{one_m_fr * Ku.re, one_m_fr * Ku.im};
                Cx<T> Wv{one_m_fr * Kv.re, one_m_fr * Kv.im};
                if (raman) {
                    const T Rj = R[j];
                    Wu = Cx<T>{Wu.re + fr * (Rj * u.re), Wu.im + fr * (Rj * u.im)};
                    Wv = Cx<T>{Wv.re + fr * (Rj * v.re), Wv.im + fr * (Rj * v.im)};
                }
                if (steep) {
                    w[j] = Wu;
                    w[n + j] = Wv;
                } else {
                    out(i, times_ig(Wu, g), times_ig(Wv, g));
                }
            }
        }
        if (!steep) return;
        // W - (i/omega_0) IDFT(i omega DFT(W)) = IDFT((1 + omega/omega_0) DFT(W))
        Cx<T>* f = ssfm::wide_fft<T, false, kPols, S>(full, w, w == b1 ? b2 : b1,
                                                   ssfm::Steep<T>{omega, double(inv_w0)});
        const Cx<T>* V =
            ssfm::wide_fft<T, true, kPols, S>(full, f, f == b1 ? b2 : b1, ssfm::Scale{c.inv_n});
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const int j = at(i);
            if (j < n) out(i, times_ig(V[j], g), times_ig(V[n + j], g));
        }
    }

    // One RK4 step of length h on both polarizations, in the plain version's
    // order: y + h/6 ((k1 + 2 (k2 + k3)) + k4).
    __device__ __forceinline__ void nl() {
        const int n = c.n;
        const T hh = T(0.5) * h, sixth = h / T(6);
        stage(
            [&](int i, Cx<T>& u, Cx<T>& v) {
                u = y[at(i)];
                v = y[n + at(i)];
            },
            [&](int i, const Cx<T>& du, const Cx<T>& dv) {
                a[0][i] = du;
                a[1][i] = dv;
            });
        stage(
            [&](int i, Cx<T>& u, Cx<T>& v) {
                const Cx<T> yu = y[at(i)], yv = y[n + at(i)];
                u = Cx<T>{yu.re + hh * a[0][i].re, yu.im + hh * a[0][i].im};
                v = Cx<T>{yv.re + hh * a[1][i].re, yv.im + hh * a[1][i].im};
            },
            [&](int i, const Cx<T>& du, const Cx<T>& dv) {
                s[0][i] = du;
                s[1][i] = dv;
            });
        stage(
            [&](int i, Cx<T>& u, Cx<T>& v) {
                const Cx<T> yu = y[at(i)], yv = y[n + at(i)];
                u = Cx<T>{yu.re + hh * s[0][i].re, yu.im + hh * s[0][i].im};
                v = Cx<T>{yv.re + hh * s[1][i].re, yv.im + hh * s[1][i].im};
            },
            [&](int i, const Cx<T>& du, const Cx<T>& dv) {
                const Cx<T> d[kPols] = {du, dv};
#pragma unroll
                for (int q = 0; q < kPols; ++q) {
                    const Cx<T> yq = y[q * n + at(i)];
                    const Cx<T> s23{s[q][i].re + d[q].re, s[q][i].im + d[q].im};
                    a[q][i] = Cx<T>{a[q][i].re + T(2) * s23.re, a[q][i].im + T(2) * s23.im};
                    s[q][i] = Cx<T>{yq.re + h * d[q].re, yq.im + h * d[q].im};
                }
            });
        stage(
            [&](int i, Cx<T>& u, Cx<T>& v) {
                u = s[0][i];
                v = s[1][i];
            },
            [&](int i, const Cx<T>& du, const Cx<T>& dv) {
                const Cx<T> d[kPols] = {du, dv};
#pragma unroll
                for (int q = 0; q < kPols; ++q) {
                    Cx<T>& yq = y[q * n + at(i)];
                    yq = Cx<T>{yq.re + sixth * (a[q][i].re + d[q].re),
                               yq.im + sixth * (a[q][i].im + d[q].im)};
                }
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

// The loop every kernel of this file runs over one instance: y0 in, then
// save chunks of st.steps(save_every) with the finite check, the save and
// each polarization's peak, then the trailing steps.
template <typename T, class St>
__device__ __forceinline__ void integrate(St& st, const Cx<T>* y0, T* pk_out, Cx<T>* y_last,
                                          uint8_t* ok_out, int n_steps, int save_every) {
    const Block<T>& c = st.c;
    const int bi = blockIdx.x, n = c.n, n2 = kPols * n;
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

template <typename T, class St>
__device__ __forceinline__ void setup(St& st, const Cx<double>* tw, unsigned char* smem, int n) {
    st.c.tw = tw;
    st.c.red = reinterpret_cast<T*>(smem);
    st.c.n = n;
    ssfm::split(n, &st.c.m, &st.c.r);
    st.c.tid = threadIdx.x;
    st.c.nt = blockDim.x;
    st.c.inv_n = 1.0 / n;
    st.c2 = st.c;
    st.c2.n = kPols * n;
}

template <typename T, class Op, int S>
__global__ void __launch_bounds__(ssfm::Bounds<S, false>::kThreads,
                                  ssfm::Bounds<S, false>::kBlocks)
vgnlse_ssfm_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                   const Cx<T>* __restrict__ lf, int fac_stride, const T* __restrict__ gamma,
                   const Cx<double>* __restrict__ tw, T* __restrict__ pk_out,
                   Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out, int n, int n_steps,
                   int save_every, double dz, double b, double coherent) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int bi = blockIdx.x;
    ssfm::Strang<T, S, kPols, Op, false> st;
    st.setup(tw, smem, n, lh + static_cast<size_t>(bi) * fac_stride,
             lf + static_cast<size_t>(bi) * fac_stride);
    st.op = Op{gamma[bi], T(dz), T(b), T(coherent)};
    st.run(y0, pk_out, y_last, ok_out, n_steps, save_every);
}

// Blocks an SM the nl kernel asks registers for: two (at most 128 registers
// a thread at 256 threads), one at 8 slots, whose sums of both
// polarizations would spill under 128 (in fp64 at n = 1,024 it runs 128
// threads, so that two blocks still fit; nl_threads).
template <typename T, int S>
__global__ void __launch_bounds__(ssfm::kMaxThreads, S == 8 ? 1 : 2)
vgnlse_nl_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                 const Cx<T>* __restrict__ lf, int fac_stride, const T* __restrict__ gamma,
                 const Cx<double>* __restrict__ tw, const Cx<T>* __restrict__ hrc,
                 const T* __restrict__ omega, T* __restrict__ pk_out,
                 Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out, int n, int n_steps,
                 int save_every, double dz, double b, double coherent, double f_r,
                 double inv_w0) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int bi = blockIdx.x;
    NlStepper<T, S> st;
    setup<T>(st, tw, smem, n);
    st.full = ssfm::plan(tw, n, 1, st.c.tid, st.c.nt);
    st.half = ssfm::plan(tw, n, 2, st.c.tid, st.c.nt);
    Cx<T>* buf = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
    st.y = buf;
    st.b1 = buf + kPols * n;
    st.b2 = buf + 2 * kPols * n;
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
    st.raman = f_r > 0.0;
    st.steep = inv_w0 != 0.0;
    integrate<T>(st, y0, pk_out, y_last, ok_out, n_steps, save_every);
}

size_t shared_bytes(int n, size_t elem, int body) {
    const size_t buffers = body == kNl ? kNlBuffers : kRotationBuffers;
    return elem * (kReduceSlots + 2 * buffers * static_cast<size_t>(n));
}

// Threads a block of the nl kernel: half the samples of both polarizations,
// at most ssfm::kMaxThreads (2n is a multiple of 256), but in fp64 above
// n = 512 about n/8 (a multiple of 32; 128 at n = 1,024), so that each
// thread holds 8 slots: the fp64 sums of both polarizations then stay in
// registers (the 8-slot instantiation takes them without spilling) and two
// blocks of 128 threads still fit an SM's registers.
int nl_threads(int n, size_t elem) {
    if (elem == sizeof(double) && n > 512) return (n / 8 + 31) / 32 * 32;
    return ssfm::threads_for(kPols * n);
}

// Slots a thread of the nl kernel: ceil(n / threads) rounded up to 1, 2, 4
// or 8.
int nl_slots(int n, int nt) {
    const int need = (n + nt - 1) / nt;
    return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

template <typename K, typename... Args>
int launch_kernel(K kernel, int B, int nt, size_t smem, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// The rotation or coherent body at the width's block (ssfm::strang_block),
// the wide launch bounds at every width.
template <typename T, class Op, typename... Args>
int launch_strang(int B, int n, size_t smem, void* stream, Args... args) {
    int S, passes;
    const int nt = ssfm::strang_block(n, &S, &passes);
    if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (S == 8) return launch_kernel(vgnlse_ssfm_kernel<T, Op, 8>, B, nt, smem, stream, args...);
    return launch_kernel(vgnlse_ssfm_kernel<T, Op, 4>, B, nt, smem, stream, args...);
}

template <typename T>
int launch_body(int body, const void* y0, const void* lh, const void* lf, int fac_stride,
                const void* gamma, const void* tw, const void* hrc, const void* omega, void* pk,
                void* y_last, void* ok, int B, int n, int n_steps, int save_every, double dz,
                double b, double coherent, double f_r, double inv_w0, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T), body);
    const auto* y0_ = static_cast<const Cx<T>*>(y0);
    const auto* lh_ = static_cast<const Cx<T>*>(lh);
    const auto* lf_ = static_cast<const Cx<T>*>(lf);
    const auto* g_ = static_cast<const T*>(gamma);
    const auto* tw_ = static_cast<const Cx<double>*>(tw);
    const auto* hrc_ = static_cast<const Cx<T>*>(hrc);
    const auto* om_ = static_cast<const T*>(omega);
    auto* pk_ = static_cast<T*>(pk);
    auto* yl_ = static_cast<Cx<T>*>(y_last);
    auto* ok_ = static_cast<uint8_t*>(ok);
    if (body == kRotation)
        return launch_strang<T, Rotation<T>>(B, n, smem, stream, y0_, lh_, lf_, fac_stride, g_,
                                             tw_, pk_, yl_, ok_, n, n_steps, save_every, dz, b,
                                             coherent);
    if (body == kCoherent)
        return launch_strang<T, Coherent<T>>(B, n, smem, stream, y0_, lh_, lf_, fac_stride, g_,
                                             tw_, pk_, yl_, ok_, n, n_steps, save_every, dz, b,
                                             coherent);
    if (body != kNl) return static_cast<int>(cudaErrorInvalidValue);
    const int nt = nl_threads(n, sizeof(T)), slots = nl_slots(n, nt);
    if (slots == 1)
        return launch_kernel(vgnlse_nl_kernel<T, 1>, B, nt, smem, stream, y0_, lh_, lf_,
                             fac_stride, g_, tw_, hrc_, om_, pk_, yl_, ok_, n, n_steps,
                             save_every, dz, b, coherent, f_r, inv_w0);
    if (slots == 2)
        return launch_kernel(vgnlse_nl_kernel<T, 2>, B, nt, smem, stream, y0_, lh_, lf_,
                             fac_stride, g_, tw_, hrc_, om_, pk_, yl_, ok_, n, n_steps,
                             save_every, dz, b, coherent, f_r, inv_w0);
    // fp64 takes 8 slots above n = 512 (nl_threads): its 4-slot kernel, whose
    // sums would spill at two blocks an SM, is never built
    if constexpr (sizeof(T) != sizeof(double)) {
        if (slots == 4)
            return launch_kernel(vgnlse_nl_kernel<T, 4>, B, nt, smem, stream, y0_, lh_, lf_,
                                 fac_stride, g_, tw_, hrc_, om_, pk_, yl_, ok_, n, n_steps,
                                 save_every, dz, b, coherent, f_r, inv_w0);
    }
    return launch_kernel(vgnlse_nl_kernel<T, 8>, B, nt, smem, stream, y0_, lh_, lf_, fac_stride,
                         g_, tw_, hrc_, om_, pk_, yl_, ok_, n, n_steps, save_every, dz, b,
                         coherent, f_r, inv_w0);
}

}  // namespace

// Bytes of dynamic shared memory one block takes (body 0 rotation,
// 1 coherent, 2 nl).
extern "C" int vgnlse_ssfm_shared_bytes(int n, int elem, int body) {
    return static_cast<int>(shared_bytes(n, static_cast<size_t>(elem), body));
}

// The rotation and coherent bodies' block at width n: its threads,
// samples a thread of each polarization and passes a transform
// (ssfm::strang_block).
extern "C" int vgnlse_ssfm_strang_block(int n, int* slots, int* passes) {
    return ssfm::strang_block(n, slots, passes);
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
