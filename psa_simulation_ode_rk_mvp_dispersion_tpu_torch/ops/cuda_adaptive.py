"""The batched adaptive (rk45) 4-wave solve on the card: the CUDA kernel, its
wrapper, and the plain PyTorch version of the same function.

Counterpart of the JAX package's ``ops/pallas_adaptive.py`` (kernel K3) and
of the scan path ``parallel/sweep._solve_batch_rk45``.  The TPU kernel
becomes the hand-written CUDA template ``csrc/fwm4_rk45.cu``: float64
serves ``x64``/``df32``, float32 serves ``x32``.

- :func:`solve_batch_rk45_cuda` checks its inputs, lays them out as (rows,
  B) structure-of-arrays buffers, launches the kernel on the current stream
  and counts the launch in ``ops/_build.LAUNCHES``.  It takes CUDA tensors
  only.
- :func:`solve_batch_rk45_torch` is the plain version: the same
  integration through ``ops/adaptive.integrate_adaptive_reduce``, batched
  over ``(B, 4)`` complex tensors.  Its RHS, ``ops/rhs.rhs_yaman_autonomous``,
  is written in the kernel's real arithmetic, operation for operation, and
  the kernel's float32 instantiation forms its products without FMA
  contraction (``__fmul_rn``), so the two take the same steps: in float32
  the error estimate is mostly rounding noise, and any difference in
  rounding would flip accept/reject decisions.  The float64 instantiation
  contracts, and takes the same steps all the same.  The CPU path and the
  comparisons on the card use it.

Both integrate ``n_steps // save_every`` saved segments of length
``save_every * dz`` and then the trailing ``n_steps % save_every`` steps'
span, unsaved, each in local z; the first step is ``dt0 = 0.1 *`` the first
span's length (the JAX scan's rule, ``adaptive.py:216-217``; the JAX kernel
starts from ``dz`` instead, ``pallas_adaptive.py:415``, and the two agree
only at ``save_every=10``).  The kernel takes every saved segment to be as
long as the first; the plain version takes the differences of the save
grid, which can differ from it in the last bit where ``k * save_every * dz``
is not exact (never on the bench grid, ``dz = 0.2``, ``save_every = 10``).
Both return ``P_max`` over the saved samples, the lab-frame state at the
last saved z, ``ok``, and the accepted and rejected step counts of each
lane.  With no saved segment, ``P_max`` and ``A_end`` are the initial
values, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build
from .adaptive import integrate_adaptive_reduce
from .cuda_solver import _DTYPE_SUFFIX, _to_lab, check_lanes
from .rhs import RHSCoeffs, rhs_yaman_autonomous


@dataclasses.dataclass(frozen=True)
class AdaptiveBatchResult:
    """Per-instance summaries, tensors on the solve's device."""

    P_max: torch.Tensor       # (B, 4) real: max power over the saved samples [W]
    A_end: torch.Tensor       # (B, 4) complex: lab-frame state at the last saved z
    ok: torch.Tensor          # (B,) bool
    n_accepted: torch.Tensor  # (B,) int32
    n_rejected: torch.Tensor  # (B,) int32


def _check_inputs(A0, gamma, alpha, delta_beta, n_steps, save_every, rtol, atol, max_steps):
    B, rdt = check_lanes(A0, gamma, alpha, delta_beta, n_steps, save_every)
    if not (rtol > 0.0 and atol >= 0.0 and max_steps >= 1):
        raise ValueError("need rtol > 0, atol >= 0 and max_steps >= 1")
    return B, rdt


def save_grid(dz_m: float, n_steps: int, save_every: int):
    """The save grid of a solve, laid out as the JAX package lays it out
    (``parallel/sweep.py:562``): ``(z_grid, z_final)``, ``z_grid`` the
    ``n_steps // save_every + 1`` saved points ``k * (save_every * dz_m)``,
    ``z_final = n_steps * dz_m`` when a trailing unsaved span remains, else
    None."""
    n_chunks = int(n_steps) // int(save_every)
    z_grid = np.arange(n_chunks + 1, dtype=np.float64) * (float(save_every) * float(dz_m))
    z_final = int(n_steps) * float(dz_m) if int(n_steps) % int(save_every) else None
    return z_grid, z_final


def kernel_segments(dz_m: float, n_steps: int, save_every: int):
    """The save grid as the rk45 kernels take it: ``(n_chunks, seg_len,
    tail_len, dt0)``, every saved segment as long as the first, and ``dt0``
    the plain version's first step (0.1 x the first span, saved or
    trailing)."""
    z_grid, z_final = save_grid(dz_m, n_steps, save_every)
    n_chunks = len(z_grid) - 1
    seg_len = float(z_grid[1] - z_grid[0]) if n_chunks else 0.0
    tail_len = 0.0 if z_final is None else z_final - float(z_grid[-1])
    return n_chunks, seg_len, tail_len, 0.1 * (seg_len if n_chunks else tail_len)


def rk45_reduce(rhs, A0, coeffs: RHSCoeffs, *, dz_m: float, n_steps: int, save_every: int,
                rtol: float, atol: float, max_steps: int):
    """Integrate a ``(B, n)`` batch (4 waves, or N comb lines) adaptively
    with plain torch (:func:`ops.adaptive.integrate_adaptive_reduce`) over
    the save grid of ``(dz_m, n_steps, save_every)`` and keep the running
    max power:
    ``(P_max, y_last, ok, n_accepted, n_rejected)``.  ``rhs(z, y, coeffs)``
    is called at global ``z`` (the lab frame uses it)."""
    z_grid, z_final = save_grid(dz_m, n_steps, save_every)
    r = integrate_adaptive_reduce(
        rhs, A0, coeffs, z_grid=z_grid, z_final=z_final,
        reduce_init=A0.real * A0.real + A0.imag * A0.imag,
        reduce_fn=lambda pmax, y: torch.maximum(pmax, y.real * y.real + y.imag * y.imag),
        rtol=rtol, atol=atol, max_steps_per_segment=max_steps, batch_ndim=1)
    return r.reduction, r.y_final, r.ok, r.n_accepted, r.n_rejected


def solve_batch_rk45_torch(A0, gamma, alpha, delta_beta, *, dz_m: float, n_steps: int,
                           save_every: int, rtol: float, atol: float,
                           max_steps: int = 1_000_000) -> AdaptiveBatchResult:
    """Plain PyTorch version of :func:`solve_batch_rk45_cuda`: the same
    rotating-frame adaptive integration, on whatever device the tensors are."""
    _check_inputs(A0, gamma, alpha, delta_beta, n_steps, save_every, rtol, atol, max_steps)
    pmax, y_last, ok, na, nr = rk45_reduce(
        rhs_yaman_autonomous, A0, RHSCoeffs(gamma, alpha, delta_beta), dz_m=dz_m,
        n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol, max_steps=max_steps)
    return AdaptiveBatchResult(
        P_max=pmax,
        A_end=_to_lab(y_last, delta_beta, dz_m=dz_m, n_steps=n_steps, save_every=save_every),
        ok=ok, n_accepted=na, n_rejected=nr,
    )


def _launcher(rdt: torch.dtype):
    fn = getattr(_build.load_library("fwm4_rk45"), f"fwm4_rk45_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_double] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def solve_batch_rk45_cuda(A0, gamma, alpha, delta_beta, *, dz_m: float, n_steps: int,
                          save_every: int, rtol: float, atol: float,
                          max_steps: int = 1_000_000) -> AdaptiveBatchResult:
    """Solve B rotating-frame instances adaptively with the CUDA kernel.

    ``A0`` is a ``(B, 4)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor; ``gamma``, ``alpha`` and ``delta_beta`` are ``(B,)``
    tensors of the matching real dtype on the same device.  ``max_steps``
    bounds the attempts of one lane in one segment.  Returns without
    synchronizing; the outputs are ordinary tensors on the stream.
    """
    B, rdt = _check_inputs(A0, gamma, alpha, delta_beta, n_steps, save_every, rtol, atol,
                           max_steps)
    if A0.device.type != "cuda":
        raise ValueError(f"solve_batch_rk45_cuda needs CUDA tensors, got a tensor on {A0.device}")
    n_chunks, seg_len, tail_len, dt0 = kernel_segments(dz_m, n_steps, save_every)
    coef = torch.stack([gamma, alpha, delta_beta])                # (3, B)
    y0 = torch.cat([A0.real.T, A0.imag.T]).contiguous()           # (8, B)
    dev = A0.device
    pmax = torch.empty((4, B), dtype=rdt, device=dev)
    y_last = torch.empty((8, B), dtype=rdt, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    na = torch.empty((B,), dtype=torch.int32, device=dev)
    nr = torch.empty((B,), dtype=torch.int32, device=dev)
    name = f"fwm4_rk45_{_DTYPE_SUFFIX[rdt]}"
    with torch.cuda.device(dev):   # the C side reads the current card
        err = _launcher(rdt)(
            coef.data_ptr(), y0.data_ptr(), pmax.data_ptr(), y_last.data_ptr(), ok.data_ptr(),
            na.data_ptr(), nr.data_ptr(), B, n_chunks, seg_len, tail_len, dt0,
            float(rtol), float(atol), int(max_steps), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[name] += 1
    A_rot = torch.complex(y_last[:4].T, y_last[4:].T)
    return AdaptiveBatchResult(
        P_max=pmax.T,
        A_end=_to_lab(A_rot, delta_beta, dz_m=dz_m, n_steps=n_steps, save_every=save_every),
        ok=ok.bool(), n_accepted=na, n_rejected=nr,
    )
