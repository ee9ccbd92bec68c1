"""The batched adaptive (rk45) comb solve on the card: the CUDA kernel, its
wrapper, and the plain PyTorch version of the same function.

Counterpart of the JAX package's ``ops/pallas_comb_adaptive.py`` (kernel K5)
and of its scan path ``models/nwave._comb_batch_adaptive_solver``.  The TPU
kernel becomes the hand-written CUDA template ``csrc/comb_rk45.cu``: float64
serves ``x64``/``df32``, float32 serves ``x32``.  It evaluates the cubic sum
through K4's FFT coupling (``csrc/comb_common.cuh``), its own radix-4 FFTs
at ``ops/cuda_comb.kernel_fft_len`` points on a float64 table.

- :func:`solve_comb_batch_rk45_cuda` checks its inputs, lays them out as one
  row per comb, launches one thread block per comb (one warp up to N = 64
  lines) on the current stream and counts the launch in
  ``ops/_build.LAUNCHES``.  CUDA tensors only.
- :func:`solve_comb_batch_rk45_torch` is the plain version:
  ``ops/adaptive.integrate_adaptive_reduce`` over the ``(B, N)`` state with,
  by default, the kernels' own coupling arithmetic
  (``ops/cuda_comb.kernel_polarization``).

Both run the port's controller (``ops/adaptive.py``, as kernel K3 does), not
the JAX kernel's: the first step is ``dt0 = 0.1 x`` the first span where the
JAX kernel starts from ``dz``, the first stage carries over from the last
accepted step (6 RHS per attempt, where the JAX kernel evaluates 7), and the
step factor is a ``pow``.  So against the JAX kernel the port is held only to
that kernel's tolerance class, never to its step counts.  Against its plain
version the kernel is held to the same steps: the kernel is built without
FMA contraction (``ops/_build.py``), and the plain version computes the
cubic sum with the kernel's passes and rounding points, every other
product and sum as one torch operation, and the error norm's mean as a true
division (``ops/adaptive._error_norm``), as the kernel's.  In float32,
where the error estimate of a step is mostly rounding noise, that is what
makes the two accept and reject the same steps and a failed comb freeze the
same last accepted state (``chip_comb_rk45_probe.py`` checks the step
factor's ``pow`` and the mean against torch's on the card).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .cuda_adaptive import kernel_segments, rk45_reduce
from .cuda_comb import (KERNEL_COUPLING, _DTYPE_SUFFIX, check_comb_lanes, kernel_length,
                        plain_rhs, twiddles)
from ..models.nwave import NWaveCoeffs
from ..utils.checks import device_key


@dataclasses.dataclass(frozen=True)
class CombAdaptiveResult:
    """Per-comb summaries, tensors on the solve's device (the counterpart of
    the JAX package's ``PallasCombAdaptiveResult``)."""

    P_max: torch.Tensor       # (B, N) real: per-line max over the saved samples [W]
    A_end: torch.Tensor       # (B, N) complex: state at the last saved grid point
    ok: torch.Tensor          # (B,) bool
    n_accepted: torch.Tensor  # (B,) int32
    n_rejected: torch.Tensor  # (B,) int32


def _check_inputs(A0, gamma, alpha, beta_lin, n_steps, save_every, rtol, atol, max_steps):
    B, N, rdt = check_comb_lanes(A0, gamma, alpha, beta_lin, n_steps, save_every)
    if not (rtol > 0.0 and atol >= 0.0 and max_steps >= 1):
        raise ValueError("need rtol > 0, atol >= 0 and max_steps >= 1")
    return B, N, rdt


def solve_comb_batch_rk45_torch(A0, gamma, alpha, beta_lin, *, dz_m: float, n_steps: int,
                                save_every: int, rtol: float, atol: float,
                                max_steps: int = 10_000,
                                coupling: str = KERNEL_COUPLING) -> CombAdaptiveResult:
    """Plain PyTorch version of :func:`solve_comb_batch_rk45_cuda`, on
    whatever device the tensors are; ``coupling`` picks the evaluation of
    the cubic sum: the kernels' arithmetic by default, or one of
    ``models/nwave``'s couplings.  The loop runs once per attempt of the
    slowest comb."""
    _check_inputs(A0, gamma, alpha, beta_lin, n_steps, save_every, rtol, atol, max_steps)
    pmax, y_last, ok, na, nr = rk45_reduce(
        plain_rhs(coupling), A0, NWaveCoeffs(gamma, alpha, beta_lin), dz_m=dz_m,
        n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol, max_steps=max_steps)
    return CombAdaptiveResult(P_max=pmax, A_end=y_last, ok=ok, n_accepted=na, n_rejected=nr)


def _launcher(rdt: torch.dtype):
    fn = getattr(_build.load_library("comb_rk45"), f"comb_rk45_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_double] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def solve_comb_batch_rk45_cuda(A0, gamma, alpha, beta_lin, *, dz_m: float, n_steps: int,
                               save_every: int, rtol: float, atol: float,
                               max_steps: int = 10_000) -> CombAdaptiveResult:
    """Solve B combs adaptively with the CUDA kernel, one thread block per
    comb (one warp of 32 threads up to N = 64 lines), in one launch.

    ``A0`` is a ``(B, N)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor; ``gamma``/``alpha`` ``(B,)`` and ``beta_lin``
    ``(B, N)`` of the matching real dtype on the same device.  ``max_steps``
    bounds the attempts of one comb in one segment.  It raises for a comb
    wider than the kernel takes (N > 2,048) or whose block does not fit in
    the card's shared memory.  Returns without synchronizing.
    """
    B, N, rdt = _check_inputs(A0, gamma, alpha, beta_lin, n_steps, save_every, rtol, atol,
                              max_steps)
    if A0.device.type != "cuda":
        raise ValueError(
            f"solve_comb_batch_rk45_cuda needs CUDA tensors, got a tensor on {A0.device}")
    dev = A0.device
    L = kernel_length("comb_rk45", N, rdt, dev)
    n_chunks, seg_len, tail_len, dt0 = kernel_segments(dz_m, n_steps, save_every)
    tw = twiddles(L, torch.float64, device_key(dev))
    y0 = torch.cat([A0.real, A0.imag], dim=1).contiguous()        # (B, 2N)
    pmax = torch.empty((B, N), dtype=rdt, device=dev)
    y_last = torch.empty((B, 2 * N), dtype=rdt, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    na = torch.empty((B,), dtype=torch.int32, device=dev)
    nr = torch.empty((B,), dtype=torch.int32, device=dev)
    name = f"comb_rk45_{_DTYPE_SUFFIX[rdt]}"
    with torch.cuda.device(dev):   # the C side reads the current card
        err = _launcher(rdt)(
            gamma.data_ptr(), alpha.data_ptr(), beta_lin.data_ptr(), tw.data_ptr(), y0.data_ptr(),
            pmax.data_ptr(), y_last.data_ptr(), ok.data_ptr(), na.data_ptr(), nr.data_ptr(),
            B, N, L, n_chunks, seg_len, tail_len, dt0, float(rtol), float(atol), int(max_steps),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[name] += 1
    return CombAdaptiveResult(P_max=pmax, A_end=torch.complex(y_last[:, :N], y_last[:, N:]),
                              ok=ok.bool(), n_accepted=na, n_rejected=nr)
