"""The batched N-wave comb solve on the card: the CUDA kernel, its wrapper,
and the plain PyTorch version of the same function.

Counterpart of the JAX package's ``ops/pallas_comb.py`` (kernel K4) and of
its scan path ``models/nwave._comb_batch_solver``.  The TPU kernel becomes
the hand-written CUDA template ``csrc/comb_rk.cu``: float64 serves
``x64``/``df32``, float32 serves ``x32``, each with RK4, AB4 and ABM4.  It
evaluates the cubic sum through its own FFTs (``csrc/comb_common.cuh``'s
FFT coupling) at :func:`kernel_fft_len` points.

- :func:`solve_comb_batch_cuda` checks its inputs, lays them out as one row
  per instance (``[Re A | Im A]``), launches one thread block per comb (one
  warp up to N = 64 lines) on the current stream and counts the launch in
  ``ops/_build.LAUNCHES``.  It takes CUDA tensors only, and raises for a
  comb wider than the kernel takes (N > 2,048) or whose block does not fit
  in the card's shared memory.
- :func:`solve_comb_batch_torch` is the plain version:
  ``ops/integrators.integrate_reduce`` over the ``(B, N)`` complex state
  with, by default, the kernels' own coupling arithmetic
  (:func:`kernel_polarization`: the same radix-4 passes on the same float64
  table, rounded where the kernel rounds).  The CPU path and the
  comparisons on the card use it.

Both return ``P_max`` over the saved samples (row 0 included), the state at
the last saved point, ``z = (n_steps // save_every) * save_every * dz``, and
``ok``.  The kernel contracts products and sums outside its transforms to
FMA where the compiler chooses (``comb_rk.cu`` is built with the default
``-fmad``), so the two agree to rounding, not bit for bit.

Why the plain coupling is the kernels' and not a dense or library
transform: the adaptive kernel K5 in float32 accepts or rejects a step of a
blowing-up comb on the last bit of each rounding, so a plain version whose
cubic sum rounds elsewhere (dense float32 sums, or the sum in float64
rounded once) fails that comb at another step and freezes another state.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .cuda_solver import _COMPLEX_OF, _DTYPE_SUFFIX, reduce_pmax_last
from ..models.nwave import NWaveCoeffs, _fft_len, _rhs_of, dft_roots, make_rhs_nwave

METHODS = ("rk4", "ab4", "abm4")
# The plain versions' default coupling: the comb kernels' arithmetic.
KERNEL_COUPLING = "kernel"


@dataclasses.dataclass(frozen=True)
class CombBatchResult:
    """Per-comb summaries, tensors on the solve's device."""

    P_max: torch.Tensor   # (B, N) real: max line power over the saved samples [W]
    A_end: torch.Tensor   # (B, N) complex: state at the last saved z
    ok: torch.Tensor      # (B,) bool: no non-finite state in any step


def check_comb_lanes(A0, gamma, alpha, beta_lin, n_steps, save_every):
    """Validate a comb batch for the kernels: ``(B, N)`` complex64/128
    ``A0``, ``(B,)`` ``gamma``/``alpha`` and ``(B, N)`` ``beta_lin`` of the
    matching real dtype on its device, all contiguous.  Returns ``(B, N,
    real dtype)``."""
    if A0.ndim != 2 or A0.shape[0] < 1 or A0.shape[1] < 1:
        raise ValueError(f"A0 must have shape (B, N) with B, N >= 1, got {tuple(A0.shape)}")
    B, N = A0.shape
    rdt = A0.real.dtype
    if rdt not in _COMPLEX_OF or A0.dtype != _COMPLEX_OF[rdt]:
        raise ValueError(f"A0 must be complex64 or complex128, got {A0.dtype}")
    for name, v, shape in (("gamma", gamma, (B,)), ("alpha", alpha, (B,)),
                           ("beta_lin", beta_lin, (B, N))):
        if tuple(v.shape) != shape or v.dtype != rdt or v.device != A0.device:
            raise ValueError(
                f"{name} must be a {shape} {rdt} tensor on {A0.device}, got "
                f"{tuple(v.shape)} {v.dtype} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_steps < 0 or save_every < 1:
        raise ValueError("need n_steps >= 0 and save_every >= 1")
    return B, N, rdt


def solve_comb_batch_torch(A0, gamma, alpha, beta_lin, *, dz_m: float, n_steps: int,
                           save_every: int, integrator: str = "rk4", check_nan: bool = True,
                           coupling: str = KERNEL_COUPLING) -> CombBatchResult:
    """Plain PyTorch version of :func:`solve_comb_batch_cuda`: the same
    integration, NaN freeze and save-grid reductions, on whatever device the
    tensors are.  ``coupling`` picks the evaluation of the cubic sum: the
    kernels' arithmetic (:data:`KERNEL_COUPLING`) by default, or one of
    ``models/nwave``'s couplings."""
    check_comb_lanes(A0, gamma, alpha, beta_lin, n_steps, save_every)
    if integrator not in METHODS:
        raise ValueError(f"integrator must be one of {METHODS}, got {integrator!r}")
    pmax, y_last, ok = reduce_pmax_last(
        plain_rhs(coupling), A0, NWaveCoeffs(gamma, alpha, beta_lin), dz_m=dz_m,
        n_steps=n_steps, save_every=save_every, integrator=integrator, check_nan=check_nan)
    return CombBatchResult(P_max=pmax, A_end=y_last, ok=ok)


# The widest transform the comb kernels take: 4,096 points, N <= 2,048 lines
# (8 lines a thread of 256; csrc/comb_rk.cu, csrc/comb_rk45.cu).
MAX_FFT_LEN = 4096


def kernel_fft_len(n_waves: int) -> int:
    """The comb kernels' transform length: ``max(128, _fft_len(N))``.  Any
    length of at least 2N - 1 gives the same cubic sum on the N lines; 128
    makes a comb of up to 64 lines one warp whose first and last passes are
    its own lines."""
    return max(128, _fft_len(n_waves))


@functools.lru_cache(maxsize=16)
def twiddles(L: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """The ``(L, 2)`` table of ``(cos, sin)(2 pi k / L)``, from
    :func:`models.nwave.dft_roots` rounded to ``dtype``: the plain version's
    dense matrices are built from the same roots; both comb kernels take it
    in float64, their butterflies run in double."""
    c, s = dft_roots(L)
    return torch.as_tensor(np.stack([c, s], axis=1), device=device).to(dtype).contiguous()


@functools.lru_cache(maxsize=64)
def _tables(L: int, ns: int, inv: bool, device: str):
    """The ``(3, L/4)`` float64 twiddles ``(w.re, wi)`` of butterfly j's
    points q = 1..3 in a radix-4 pass at sub-transform length ``ns``:
    ``tw[q (j mod ns) L/(4 ns)]``, ``wi`` the sine for the inverse and its
    negation for the forward transform (``ssfm_common.cuh``'s
    ``wide_pass``)."""
    tw = twiddles(L, torch.float64, device)
    k = torch.arange(L // 4, device=device) % ns
    idx = torch.arange(1, 4, device=device)[:, None] * k[None, :] * (L // (4 * ns))
    wi = tw[idx, 1] if inv else -tw[idx, 1]
    return tw[idx, 0].contiguous(), wi.contiguous()


def _pass(z, R: int, ns: int, inv: bool, post=None):
    """One radix-R Stockham pass of an L-point transform (``ssfm_common.cuh``'s
    ``wide_pass`` with m = L, r = 1) on ``z``, the ``(..., 2, L)`` real and
    imaginary parts stored at the state's type: butterfly j takes points
    j + q L/R, turns point q by its twiddle (ns > 1), combines them in
    float64, and output q lands at (j - j mod ns) R + j mod ns + q ns,
    rounded once to the state's type after ``post`` (on the float64 parts).
    Every product and sum is a torch operation of its own (a part of each
    point's), so that nothing contracts to FMA; the real and imaginary parts
    share an operation where they take the same one."""
    rdt, L = z.dtype, z.shape[-1]
    lead = z.shape[:-2]
    x = z.to(torch.float64).reshape(lead + (2, R, L // R))
    if ns > 1:   # (xr wr - xi wi, xr wi + xi wr) for points 1..R-1
        wr, wi = _tables(L, ns, inv, str(z.device))
        pr, pi = x[..., 1:, :] * wr, x[..., 1:, :] * wi
        turned = torch.stack([pr[..., 0, :, :] - pi[..., 1, :, :],
                              pi[..., 0, :, :] + pr[..., 1, :, :]], -3)
        x = torch.cat([x[..., :1, :], turned], -2)
    xq = x.unbind(-2)
    if R == 2:
        out = [xq[0] + xq[1], xq[0] - xq[1]]
    else:
        a0, a1 = xq[0] + xq[2], xq[0] - xq[2]
        a2, a3 = xq[1] + xq[3], xq[1] - xq[3]
        re, im = a3.unbind(-2)
        # -i a3 (forward) or i a3 (inverse): X1 = a1 + that, X3 = a1 - that
        j3 = torch.stack([-im, re] if inv else [im, -re], -2)
        out = [a0 + a2, a1 + j3, a0 - a2, a1 - j3]
    out = torch.stack(out, -2)                          # (..., 2, R, L/R)
    if post is not None:
        out = post(out)
    # output q of butterfly j = a ns + k at a R ns + q ns + k
    out = out.reshape(lead + (2, R, L // (R * ns), ns)).transpose(-3, -2)
    return out.reshape(lead + (2, L)).to(rdt)


def _power(v):
    """G = F |F|^2 on ``(..., 2, ...)`` float64 parts, |F|^2 = Fr Fr + Fi Fi."""
    re, im = v.unbind(-3)
    mag = re * re + im * im
    return v * mag.unsqueeze(-3)


def kernel_polarization(a: torch.Tensor) -> torch.Tensor:
    """The comb kernels' cubic sum ``T = (1/L) IDFT(F |F|^2)[0:N]``, ``F =
    DFT_L(A)``, computed as ``csrc/comb_common.cuh``'s ``Coupling`` computes
    it, rounding for rounding: L = :func:`kernel_fft_len`, the float64
    table of :func:`twiddles`, radix-4 Stockham passes (one radix-2 pass
    first when log2 L is odd) with every butterfly and twiddle product in
    float64 and each pass's outputs stored at the state's type, G = F |F|^2
    formed in the last forward pass before it is stored, and the inverse's
    last outputs times 1/L rounded once.  ``a`` is ``(..., N)`` complex."""
    n = a.shape[-1]
    L = kernel_fft_len(n)
    lead = a.shape[:-1]
    odd = (L.bit_length() - 1) & 1
    z = torch.zeros(lead + (2, L), dtype=a.real.dtype, device=a.device)
    parts = torch.stack([a.real, a.imag], -2)                # (..., 2, N)
    if odd:   # radix 2 on (x[j], 0): out[2j] = out[2j+1] = x[j]
        z.view(lead + (2, L // 2, 2))[..., :n, :] = parts[..., None]
    else:     # radix 4 on (x[j], x[j + L/4], 0, 0)
        z[..., :n] = parts
        z = _pass(z, 4, 1, False)
    ns = 2 if odd else 4
    while ns < L:
        z = _pass(z, 4, ns, False, _power if ns == L // 4 else None)
        ns *= 4
    ns = 1
    if odd:
        z = _pass(z, 2, 1, True)
        ns = 2
    while ns < L:
        z = _pass(z, 4, ns, True, (lambda v: v * (1.0 / L)) if ns == L // 4 else None)
        ns *= 4
    return torch.complex(z[..., 0, :n], z[..., 1, :n])


def plain_rhs(coupling: str = KERNEL_COUPLING):
    """The comb RHS of the plain versions: the cubic sum by
    :func:`kernel_polarization` for :data:`KERNEL_COUPLING`, else
    ``models/nwave.make_rhs_nwave(coupling)``."""
    if coupling == KERNEL_COUPLING:
        return _rhs_of(kernel_polarization)
    return make_rhs_nwave(coupling)


def kernel_length(prefix: str, n: int, rdt: torch.dtype, device: torch.device) -> int:
    """The transform length of the ``prefix`` comb kernel (``comb_rk`` or
    ``comb_rk45``) at ``n`` lines; raise if the kernel does not take it or
    one block does not fit in the card's shared memory."""
    L = kernel_fft_len(n)
    need_fn = getattr(_build.load_library(prefix), f"{prefix}_shared_bytes")
    need_fn.argtypes, need_fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    need = need_fn(n, L, torch.finfo(rdt).bits // 8)
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(
            f"a comb of N={n} lines needs {need} bytes of shared memory per block in "
            f"{prefix}; this card allows {limit}: use engine='torch' for it")
    if L > MAX_FFT_LEN:
        raise ValueError(f"a comb of N={n} lines needs a {L}-point transform; the comb kernels "
                         f"take up to {MAX_FFT_LEN} (N <= {MAX_FFT_LEN // 2}): use "
                         "engine='torch' for it")
    return L


def _launcher(rdt: torch.dtype, integrator: str):
    fn = getattr(_build.load_library("comb_rk"), f"comb_{integrator}_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def solve_comb_batch_cuda(A0, gamma, alpha, beta_lin, *, dz_m: float, n_steps: int,
                          save_every: int, integrator: str = "rk4",
                          check_nan: bool = True) -> CombBatchResult:
    """Solve B combs with the CUDA kernel, one thread block per comb (one
    warp of 32 threads up to N = 64 lines).

    ``A0`` is a ``(B, N)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor; ``gamma``/``alpha`` ``(B,)`` and ``beta_lin``
    ``(B, N)`` tensors of the matching real dtype on the same device.  With
    ``check_nan`` false no lane is frozen and ``ok`` stays set.  Returns
    without synchronizing; the outputs are ordinary tensors on the stream.
    """
    B, N, rdt = check_comb_lanes(A0, gamma, alpha, beta_lin, n_steps, save_every)
    if integrator not in METHODS:
        raise ValueError(f"integrator must be one of {METHODS}, got {integrator!r}")
    if A0.device.type != "cuda":
        raise ValueError(f"solve_comb_batch_cuda needs CUDA tensors, got a tensor on {A0.device}")
    dev = A0.device
    L = kernel_length("comb_rk", N, rdt, dev)
    tw = twiddles(L, torch.float64, str(dev))
    y0 = torch.cat([A0.real, A0.imag], dim=1).contiguous()        # (B, 2N)
    pmax = torch.empty((B, N), dtype=rdt, device=dev)
    y_last = torch.empty((B, 2 * N), dtype=rdt, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    name = f"comb_{integrator}_{_DTYPE_SUFFIX[rdt]}"
    err = _launcher(rdt, integrator)(
        gamma.data_ptr(), alpha.data_ptr(), beta_lin.data_ptr(), tw.data_ptr(), y0.data_ptr(),
        pmax.data_ptr(), y_last.data_ptr(), ok.data_ptr(), B, N, L, int(n_steps),
        int(save_every), int(bool(check_nan)), float(dz_m),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[f"comb_rk_{_DTYPE_SUFFIX[rdt]}"] += 1
    return CombBatchResult(P_max=pmax, A_end=torch.complex(y_last[:, :N], y_last[:, N:]),
                           ok=ok.bool())
