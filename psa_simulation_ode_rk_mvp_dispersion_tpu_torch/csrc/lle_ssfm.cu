// Batched fixed-step LLE cavity integration by the symmetric (Strang)
// split-step Fourier method with an affine linear substep, one CUDA thread
// block per cavity, the whole integration in one launch.
//
// Replaces the JAX package's TPU kernel
//   ops/pallas_gnlse.py::_kernel_body built with affine=True by
//   ops/pallas_lle.py   (K7, the LLE cavity)
// with one template, lle_ssfm_kernel<T, S, Narrow>, T in {double, float}:
// float64 serves x64/df32, float32 serves x32; S the samples a thread and
// Narrow the launch bounds (ssfm_common.cuh's Bounds).
//
// What it computes (the contract of models/lle.lle_fixed with method
// 'strang', which ops/cuda_lle.solve_lle_batch_torch runs, and of
// _lle_solver in the JAX package):
//   - every save chunk of k steps is Lh, (Kerr, Lf)^(k-1), Kerr, Lh, with
//     the linear substep y <- IDFT(L * DFT(y)) and L = Lh or Lf the factors
//     exp((-1 + i phi_d) s) for s = dz/2 and dz that the wrapper builds with
//     the plain version's own function (shared (n,) or one row per cavity);
//   - each linear substep ends with the affine write y <- y dp + dF, the
//     detuning rotation dp = exp(-i Delta s) and the drive offset
//     dF = F (e^{Lam0 s} - 1)/Lam0, Lam0 = -(1 + i Delta), of the cavity for
//     s = dz/2 (with Lh) or dz (with Lf), which the wrapper builds in
//     float64;
//   - Kerr is the exact rotation y exp(i (1 |y|^2) dz) (gamma = 1);
//   - ok starts as "y0 is finite"; after each chunk a non-finite state
//     clears ok and the cavity keeps its last good state (which it then
//     keeps for good: the rest of the run cannot change its outputs, so the
//     block stops); otherwise the state is saved and the peak, the running
//     max over saved samples of max_t |y|^2 (from y0, NaN propagating),
//     grows; the trailing n_steps % save_every steps are integrated from the
//     last saved state and feed only ok.
//
// What bounds it: the latency of the transform passes, not their arithmetic
// (at the LLE width, n = 256, a Strang step is one transform pair of about
// 10 n log2 n flop and O(n) pointwise work, one cavity a block of 2 warps).
// So it runs csrc/strang.cuh's slotted Strang body, as K6's Kerr route and
// K9's rotation and coherent bodies do, with the affine write as the linear
// substep's last write and the Kerr rotation (gamma = 1) as its NL: the
// radix-4 slot_fft passes, the factor product in the forward transform's
// last pass, the 1/n, the affine write and the next substep's Kerr rotation
// in the inverse one's, the factors in registers, and one fused reduction at
// the chunk's end.  At n = 256 a Strang step is 8 barriers (about 19 with
// radix-2 passes and separate factor, affine and Kerr passes).  The state
// and its transform partner are the only shared buffers: at n = 2,048 in
// fp64 a block takes 65,792 bytes.  The twiddles and the factors are read
// from device memory through the cache, once.
//
// Global layout (row-major, one row per cavity, complex as (re, im)):
//   y0 (B, n); lh, lf (n,) with fac_stride 0 or (B, n) with fac_stride n;
//   aff (B, 4) complex = (dp_h, dF_h, dp_f, dF_f); tw (n,) = (cos, sin)(2 pi
//   k / n) in float64; outputs peak (B,), y_last (B, n), ok (B,) uint8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes through the
// extern "C" functions at the end; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "strang.cuh"

namespace {

using ssfm::Cx;

// The LLE's pointwise operator: the affine write y dp + dF ends each linear
// substep (the scalars of dz with Lf, of dz/2 with Lh), and the NL is the
// Kerr rotation at gamma = 1.
template <typename T>
struct Affine {
    T h;
    Cx<T> dp_h, dF_h, dp_f, dF_f;
    __device__ __forceinline__ Cx<T> end(bool full, const Cx<T>& x) const {
        return ssfm::affine_of(x, full ? dp_f : dp_h, full ? dF_f : dF_h);
    }
    __device__ __forceinline__ void step(Cx<T> (&a)[1]) const {
        a[0] = ssfm::kerr_of(a[0], T(1), h);
    }
};

template <typename T, int S, bool Narrow>
__global__ void __launch_bounds__(ssfm::Bounds<S, Narrow>::kThreads,
                                  ssfm::Bounds<S, Narrow>::kBlocks)
lle_ssfm_kernel(const Cx<T>* __restrict__ y0, const Cx<T>* __restrict__ lh,
                const Cx<T>* __restrict__ lf, int fac_stride, const Cx<T>* __restrict__ aff,
                const Cx<double>* __restrict__ tw, T* __restrict__ pk_out,
                Cx<T>* __restrict__ y_last, uint8_t* __restrict__ ok_out, int n, int n_steps,
                int save_every, double dz) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    ssfm::Strang<T, S, 1, Affine<T>> st;
    st.setup(tw, smem, n, lh + static_cast<size_t>(b) * fac_stride,
             lf + static_cast<size_t>(b) * fac_stride);
    const Cx<T>* a = aff + 4 * static_cast<size_t>(b);
    st.op = Affine<T>{T(dz), a[0], a[1], a[2], a[3]};
    st.run(y0, pk_out, y_last, ok_out, n_steps, save_every);
}

size_t shared_bytes(int n, size_t elem) {
    return ssfm::strang_shared_bytes(n, 1, elem);
}

template <typename T, int S, bool Narrow>
int launch_slots(int threads, const void* y0, const void* lh, const void* lf, int fac_stride,
                 const void* aff, const void* tw, void* pk, void* y_last, void* ok, int B, int n,
                 int n_steps, int save_every, double dz, void* stream) {
    const size_t smem = shared_bytes(n, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(lle_ssfm_kernel<T, S, Narrow>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lle_ssfm_kernel<T, S, Narrow><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Cx<T>*>(y0), static_cast<const Cx<T>*>(lh),
        static_cast<const Cx<T>*>(lf), fac_stride, static_cast<const Cx<T>*>(aff),
        static_cast<const Cx<double>*>(tw), static_cast<T*>(pk), static_cast<Cx<T>*>(y_last),
        static_cast<uint8_t*>(ok), n, n_steps, save_every, dz);
    return static_cast<int>(cudaGetLastError());
}

// The width's block: S = ssfm::default_slots(n), ssfm::block_threads(n, S)
// threads, Narrow when it has at most 128.
template <typename T>
int launch(const void* y0, const void* lh, const void* lf, int fac_stride, const void* aff,
           const void* tw, void* pk, void* y_last, void* ok, int B, int n, int n_steps,
           int save_every, double dz, void* stream) {
    const int S = ssfm::default_slots(n);
    const int threads = ssfm::block_threads(n, S);
    if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
#define LLE_SSFM_ARGS \
    threads, y0, lh, lf, fac_stride, aff, tw, pk, y_last, ok, B, n, n_steps, save_every, dz, stream
    if (S == 8) return launch_slots<T, 8, false>(LLE_SSFM_ARGS);
    if (threads <= ssfm::Bounds<4, true>::kThreads) return launch_slots<T, 4, true>(LLE_SSFM_ARGS);
    return launch_slots<T, 4, false>(LLE_SSFM_ARGS);
#undef LLE_SSFM_ARGS
}

}  // namespace

// Bytes of dynamic shared memory one block takes.
extern "C" int lle_ssfm_shared_bytes(int n, int elem) {
    return static_cast<int>(shared_bytes(n, static_cast<size_t>(elem)));
}

#define LLE_SSFM_LAUNCHER(NAME, T)                                                             \
    extern "C" int NAME(const void* y0, const void* lh, const void* lf, int fac_stride,        \
                        const void* aff, const void* tw, void* pk, void* y_last, void* ok,     \
                        int B, int n, int n_steps, int save_every, double dt, void* stream) {  \
        return launch<T>(y0, lh, lf, fac_stride, aff, tw, pk, y_last, ok, B, n, n_steps,      \
                         save_every, dt, stream);                                              \
    }

LLE_SSFM_LAUNCHER(lle_ssfm_f64, double)
LLE_SSFM_LAUNCHER(lle_ssfm_f32, float)
