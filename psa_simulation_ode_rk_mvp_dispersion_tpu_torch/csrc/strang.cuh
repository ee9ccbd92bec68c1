// The slotted Strang body shared by the fixed-step split-step kernels whose
// nonlinear substep is pointwise: K6's Kerr route (csrc/gnlse_ssfm.cu), K7,
// the LLE cavity (csrc/lle_ssfm.cu), and K9's rotation and coherent bodies
// (csrc/vgnlse_ssfm.cu, two polarizations).  One thread block integrates one
// envelope (K9: one instance) of P sequences of n samples.
//
// Every save chunk of k steps is Lh, (NL, Lf)^(k-1), NL, Lh, the linear
// substep y_p <- end(IDFT(L_p DFT(y_p))), L = Lh or Lf the wrapper's factors
// for dz/2 and dz.  What bounds such a kernel is the latency of the transform
// passes and their barriers, not their arithmetic, so the design cuts passes
// and barriers:
//   - the transforms are ssfm_common.cuh's slot_fft: radix-4 Stockham passes
//     (one radix-2 pass first when log2 m is odd, the r-odd tail), a float64
//     table and every butterfly in double, one barrier a pass; both
//     sequences of K9 go through the same passes, one barrier for the pair;
//   - the pointwise work is folded into the last pass of each transform,
//     whose outputs the same thread owns in every transform: the factor
//     product L F in the forward transform's, and in the inverse one's the
//     1/n, the Op's end write (K7's affine write, none for the others) and,
//     unless it is the chunk's last substep, the next substep's NL at the
//     sample (Op::step, on the P values of one sample: K6's Kerr rotation,
//     K9's joint rotation or its coherent RK4).  So each thread keeps its
//     samples' Lh and Lf in registers, loaded once an envelope (K6, K7; K9
//     reads them through the read-only cache in that pass, Regs false, which
//     keeps it at two blocks an SM), and the state never sits in shared
//     memory between pointwise passes: a Strang step is one barrier a pass
//     of each transform, 10 at n = 1,024 (5 passes each);
//   - the chunk's last inverse transform forms each thread's finite flag and
//     peaks (one a sequence), and one fused reduction (a shuffle tree in each
//     warp, the warps' maxima in warp order, the flag ANDed at its one
//     barrier) replaces the block-wide finite check and peak.
// The state and its transform partner (P n samples each) are the only shared
// buffers, beside the 32 reduction slots.
//
// The integration (run): ok starts as "y0 is finite"; after each chunk a
// non-finite state clears ok and the envelope keeps its last saved state
// (for good: the rest of the run cannot change its outputs, so the block
// stops); otherwise the state is saved and each sequence's peak, the running
// max over saved samples of max_t |y_p|^2 (from y0, NaN propagating), grows;
// the trailing n_steps % save_every steps are integrated from the last saved
// state and feed only ok.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssfm_common.cuh"

namespace ssfm {

// Value p of a Post's argument: the value itself for one sequence, entry p
// of the pair for two.
__device__ __forceinline__ const Cx<double>& seq_of(const Cx<double>& v, int) { return v; }
__device__ __forceinline__ const Cx<double>& seq_of(const Cx<double> (&v)[2], int p) {
    return v[p];
}

// One envelope's Strang integration: P sequences of n samples, S samples a
// thread of each, the factors in registers when Regs (else read through the
// read-only cache where they are used), the pointwise operator Op:
//   Cx<T> Op::end(bool full, const Cx<T>& x): the linear substep's last write;
//   void Op::step(Cx<T> (&a)[P]): the nonlinear substep at one sample.
template <typename T, int S, int P, class Op, bool Regs = true>
struct Strang {
    static constexpr int kReduceSlots = 32;

    Block<T> c;     // n: one sequence's samples; the reduction slots
    Plan f;         // the n-point transform
    Cx<T>*y, *x;    // the state and its transform partner
    Op op;
    const Cx<T>*gh, *gf;            // the factors in device memory, (P, n)
    Cx<T> lh[P][Regs ? S : 1], lf[P][Regs ? S : 1];  // Regs: those of the thread's samples

    // The block's view, the plan and the buffers in smem (the reduction
    // slots, then y and x), and the factors of this envelope.
    __device__ __forceinline__ void setup(const Cx<double>* tw, unsigned char* smem, int n,
                                          const Cx<T>* Lh, const Cx<T>* Lf) {
        c.tw = tw;
        c.red = reinterpret_cast<T*>(smem);
        c.n = n;
        split(n, &c.m, &c.r);
        c.tid = threadIdx.x;
        c.nt = blockDim.x;
        c.inv_n = 1.0 / n;
        f = plan(tw, n, 1, c.tid, c.nt);
        y = reinterpret_cast<Cx<T>*>(smem + kReduceSlots * sizeof(T));
        x = y + P * n;
        gh = Lh;
        gf = Lf;
        if constexpr (Regs) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const bool in = slot_valid<S>(f, s);
                const int k = slot_sample(f, s);
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    lh[p][s] = in ? Lh[p * n + k] : Cx<T>{T(0), T(0)};
                    lf[p][s] = in ? Lf[p * n + k] : Cx<T>{T(0), T(0)};
                }
            }
        }
    }

    // The factor of sequence p at slot s, sample k.
    __device__ __forceinline__ Cx<T> factor(bool full, int p, int s, int k) const {
        if constexpr (Regs)
            return full ? lf[p][s] : lh[p][s];
        else
            return ldg((full ? gf : gh) + p * c.n + k);
    }

    // One transform of in through the pair (in is one of them); returns the
    // buffer the last pass's Post wrote.  No barrier after the last pass.
    template <bool INV, class Post>
    __device__ __forceinline__ Cx<T>* xf(const Cx<T>* in, const Post& post) {
        Cx<T>* s0 = in == y ? x : y;
        return slot_fft<T, INV, S, false, P>(f, in, s0, s0 == y ? x : y, post);
    }

    // One linear substep with the factors of dz (full) or dz/2, then, with
    // nl, the next substep's NL.  Without nl (a chunk's last substep) it
    // returns whether the new state is finite, in every thread, and leaves
    // each sequence's peak in pk.
    __device__ __forceinline__ bool lin(bool full, bool nl, T (&pk)[P]) {
        const int n = c.n;
        Cx<T>* u = xf<false>(y, [&](int s, int k, const auto& v, Cx<T>* o) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const Cx<double> q = times(factor(full, p, s, k), seq_of(v, p));
                o[p * n + k] = Cx<T>{T(q.re), T(q.im)};
            }
        });
        __syncthreads();
        int fin = 1;
        T peak[P];
#pragma unroll
        for (int p = 0; p < P; ++p) peak[p] = T(0);
        u = xf<true>(u, [&](int, int k, const auto& v, Cx<T>* o) {
            Cx<T> a[P];
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const Cx<double>& w = seq_of(v, p);
                a[p] = op.end(full, Cx<T>{T(w.re * c.inv_n), T(w.im * c.inv_n)});
            }
            if (nl) {
                op.step(a);
            } else {
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    fin &= (isfinite(a[p].re) && isfinite(a[p].im)) ? 1 : 0;
                    peak[p] = nan_max(peak[p], a[p].re * a[p].re + a[p].im * a[p].im);
                }
            }
#pragma unroll
            for (int p = 0; p < P; ++p) o[p * n + k] = a[p];
        });
        if (u != y) {
            x = y;
            y = u;
        }
        if (nl) {
            __syncthreads();
            return true;
        }
        // the fused reduction: a shuffle tree in each warp, the warps'
        // maxima in warp order, one barrier (which also ANDs the flag)
        const int warps = c.nt >> 5;
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                peak[p] = nan_max(peak[p], __shfl_down_sync(0xffffffffu, peak[p], o));
            if ((c.tid & 31) == 0) c.red[p * warps + (c.tid >> 5)] = peak[p];
        }
        const bool finite = __syncthreads_and(fin) != 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            pk[p] = c.red[p * warps];
            for (int w = 1; w < warps; ++w) pk[p] = nan_max(pk[p], c.red[p * warps + w]);
        }
        return finite;
    }

    // k fused symmetric steps: Lh, (NL, Lf)^(k-1), NL, Lh; whether the
    // state is finite, and its peaks in pk.
    __device__ __forceinline__ bool steps(int kk, T (&pk)[P]) {
        lin(false, true, pk);
        for (int i = 1; i < kk; ++i) lin(true, true, pk);
        return lin(false, false, pk);
    }

    // The whole integration of envelope blockIdx.x: y0 (B, P, n) in; the
    // peaks (B, P), the last saved state (B, P, n) and ok (B,) out.
    __device__ __forceinline__ void run(const Cx<T>* y0, T* pk_out, Cx<T>* y_last,
                                        uint8_t* ok_out, int n_steps, int save_every) {
        const int b = blockIdx.x, n = c.n, np = P * n;
        Cx<T>* out = y_last + static_cast<size_t>(b) * np;
        for (int j = c.tid; j < np; j += c.nt) {
            const Cx<T> v = y0[static_cast<size_t>(b) * np + j];
            y[j] = v;
            out[j] = v;
        }
        Block<T> all = c;  // the block over every sequence
        all.n = np;
        bool ok = block_finite(all, y);
        T pk[P];
#pragma unroll
        for (int p = 0; p < P; ++p) pk[p] = block_peak(c, y + p * n);
        const int n_chunks = n_steps / save_every, rem = n_steps - n_chunks * save_every;
        if (ok) {
            for (int i = 0; i < n_chunks; ++i) {
                T q[P];
                if (!steps(save_every, q)) {
                    ok = false;  // y_last keeps the last saved state
                    break;
                }
                // the thread's own samples of the new state
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    if (slot_valid<S>(f, s)) {
                        const int k = slot_sample(f, s);
#pragma unroll
                        for (int p = 0; p < P; ++p) out[p * n + k] = y[p * n + k];
                    }
                }
#pragma unroll
                for (int p = 0; p < P; ++p) pk[p] = nan_max(pk[p], q[p]);
            }
            if (ok && rem > 0) {
                T q[P];
                ok = steps(rem, q);
            }
        }
        if (c.tid == 0) {
#pragma unroll
            for (int p = 0; p < P; ++p) pk_out[P * b + p] = pk[p];
            ok_out[b] = ok ? 1 : 0;
        }
    }
};

// The block of a Strang kernel at width n: the threads it returns
// (block_threads; 0 when n is too wide), *slots = default_slots(n) samples a
// thread of each sequence, and *passes the passes of one transform
// (slot_fft's: a radix-2 pass when log2 m is odd, the radix-4 ones, the
// r-odd tail), one barrier each.  The launchers take their block from it,
// and the libraries export it, so that a log reports the launched block.
inline int strang_block(int n, int* slots, int* passes) {
    int m, r, lm = 0;
    split(n, &m, &r);
    while ((1 << lm) < m) ++lm;
    *slots = default_slots(n);
    *passes = (lm & 1) + lm / 2 + (r > 1 ? 1 : 0);
    return block_threads(n, *slots);
}

// Bytes of dynamic shared memory a Strang block takes: the reduction slots
// and two buffers of P n samples.
inline size_t strang_shared_bytes(int n, int P, size_t elem) {
    return elem * (32 + 2 * 2 * static_cast<size_t>(P) * n);
}

}  // namespace ssfm
