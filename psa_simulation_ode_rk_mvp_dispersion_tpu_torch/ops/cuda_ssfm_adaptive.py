"""The batched adaptive (rk45) split-step solves on the card: the CUDA
kernel, its wrappers, and the plain PyTorch versions of the same functions.

Counterpart of the JAX package's ``ops/pallas_ssfm_adaptive.py`` (kernel
K8) and of its scan paths ``models/gnlse._gnlse_adaptive_solver`` and
``models/lle._lle_adaptive_solver``.  Both routes of the TPU kernel become
the hand-written CUDA template ``csrc/ssfm_rk45.cu`` (Strang step
doubling; fp64 and fp32): the GNLSE route (Kerr, flat per-lane loss) and
the LLE route (unit loss and Kerr, the affine detuning rotation and drive
offset after every inverse transform).

- :func:`solve_gnlse_batch_rk45_cuda` and :func:`solve_lle_batch_rk45_cuda`
  check their inputs, launch one thread block per envelope or cavity on
  the current stream, every save segment and the trailing span in one
  launch, and count the launch in ``ops/_build.LAUNCHES``.  CUDA tensors
  only.
- :func:`solve_gnlse_batch_rk45_torch` (``models/gnlse.gnlse_adaptive``) and
  :func:`solve_lle_batch_rk45_torch` (``models/lle.lle_adaptive``) are the
  plain versions, with ``torch.fft`` transforms; they also run the calls
  the kernel does not take (``nl``, spectral loss, ``method='rk4ip'``).

Both run the JAX scan's controller, not the JAX kernel's: the JAX kernel
never shrinks the step after an accepted attempt (a guard against its bf16
transform noise), so its step sequence is only tolerance-class against the
scan's.  ``max_steps`` bounds the attempts one envelope makes in one
segment.  The JAX scan counts iterations of its batched loop instead; every
active lane attempts once an iteration and stays active from the segment's
start until it is done, so the two bounds fail the same lanes.  The kernel
transforms in shared memory with its own FFT, the plain version with
``torch.fft``, so the two round differently and, near the accept threshold,
may take other steps.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from . import _build
from .cuda_gnlse import _DTYPE_SUFFIX, check_envelopes, twiddles, width_problem
from .cuda_lle import check_cavities
from ..models.gnlse import NLTerms, gnlse_adaptive, save_segments
from ..models.lle import lle_adaptive


@dataclasses.dataclass(frozen=True)
class SSFMAdaptiveResult:
    """Per-envelope summaries, tensors on the solve's device (the
    counterpart of the JAX package's ``SSFMAdaptiveResult``)."""

    peak_max: torch.Tensor    # (B,) real: max over saved samples of max_t |A|^2 [W]
    A_end: torch.Tensor       # (B, T) complex: state at the last saved grid point
    ok: torch.Tensor          # (B,) bool
    n_accepted: torch.Tensor  # (B,) int32
    n_rejected: torch.Tensor  # (B,) int32


def _check_control(rtol, atol, max_steps):
    if not (rtol > 0.0 and atol >= 0.0 and max_steps >= 1):
        raise ValueError("need rtol > 0, atol >= 0 and max_steps >= 1")


def _check_inputs(A0, gamma, alpha, lin_phase, n_steps, save_every, rtol, atol, max_steps):
    B, T, rdt = check_envelopes(A0, gamma, alpha, lin_phase, n_steps, save_every)
    _check_control(rtol, atol, max_steps)
    return B, T, rdt


def solve_gnlse_batch_rk45_torch(A0, gamma, alpha, lin_phase, *, dz_m: float, n_steps: int,
                                 save_every: int, rtol: float, atol: float,
                                 max_steps: int = 100_000, nl: Optional[NLTerms] = None,
                                 method: str = "strang") -> SSFMAdaptiveResult:
    """Plain PyTorch version of :func:`solve_gnlse_batch_rk45_cuda`, on
    whatever device the tensors are.  The loop runs once per attempt of the
    slowest envelope."""
    _check_inputs(A0, gamma, alpha, lin_phase, n_steps, save_every, rtol, atol, max_steps)
    _rows, pk, y, ok, na, nr = gnlse_adaptive(
        A0, gamma, alpha, lin_phase, dz_m=dz_m, n_steps=n_steps, save_every=save_every,
        rtol=rtol, atol=atol, max_steps=max_steps, nl=nl, method=method)
    return SSFMAdaptiveResult(peak_max=pk, A_end=y, ok=ok, n_accepted=na, n_rejected=nr)


def _launcher(rdt: torch.dtype, route: str):
    fn = getattr(_build.load_library("ssfm_rk45"), f"{route}_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_double] * 2 + [ctypes.c_int]
                   + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(route, y0, p0, p1, lin_phase, *, dt, n_steps, save_every, rtol, atol, max_steps):
    """One launch of the ``route`` instantiation of ``csrc/ssfm_rk45.cu`` on
    checked inputs (``p0, p1``: gamma and alpha, or detuning and pump)."""
    B, T = y0.shape
    rdt = y0.real.dtype
    dev = y0.device
    n_chunks, seg, z_end, has_tail = save_segments(dt, n_steps, save_every)
    tw = twiddles(T, str(dev))
    y0 = y0.contiguous()
    pk = torch.empty((B,), dtype=rdt, device=dev)
    y_last = torch.empty((B, T), dtype=y0.dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    na = torch.empty((B,), dtype=torch.int32, device=dev)
    nr = torch.empty((B,), dtype=torch.int32, device=dev)
    name = f"{route}_{_DTYPE_SUFFIX[rdt]}"
    err = _launcher(rdt, route)(
        y0.data_ptr(), p0.data_ptr(), p1.data_ptr(), lin_phase.data_ptr(),
        0 if lin_phase.ndim == 1 else T, tw.data_ptr(), pk.data_ptr(), y_last.data_ptr(),
        ok.data_ptr(), na.data_ptr(), nr.data_ptr(), B, T, n_chunks, seg, z_end,
        int(has_tail), float(dt), float(rtol), float(atol), int(max_steps),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[name] += 1
    return SSFMAdaptiveResult(peak_max=pk, A_end=y_last, ok=ok.bool(), n_accepted=na,
                              n_rejected=nr)


def solve_gnlse_batch_rk45_cuda(A0, gamma, alpha, lin_phase, *, dz_m: float, n_steps: int,
                                save_every: int, rtol: float, atol: float,
                                max_steps: int = 100_000) -> SSFMAdaptiveResult:
    """Solve B envelopes adaptively (Strang step doubling, Kerr) with the
    CUDA kernel, one thread block per envelope, in one launch.

    ``A0`` is a ``(B, T)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor, T a multiple of 128 up to 2,048; ``gamma`` and the
    flat loss ``alpha`` ``(B,)``, ``lin_phase`` ``(T,)`` or ``(B, T)`` of the
    matching real dtype on the same device.  Returns without
    synchronizing."""
    B, T, rdt = _check_inputs(A0, gamma, alpha, lin_phase, n_steps, save_every, rtol, atol,
                              max_steps)
    if A0.device.type != "cuda":
        raise ValueError(
            f"solve_gnlse_batch_rk45_cuda needs CUDA tensors, got a tensor on {A0.device}")
    if alpha.ndim != 1:
        raise ValueError("the fused adaptive SSFM kernel supports flat per-lane loss only "
                         "(spectral alpha: engine='torch')")
    why = width_problem("ssfm_rk45", T, rdt, A0.device)
    if why is not None:
        raise ValueError(why)
    return _launch("ssfm_rk45", A0, gamma, alpha, lin_phase, dt=dz_m, n_steps=n_steps,
                   save_every=save_every, rtol=rtol, atol=atol, max_steps=max_steps)


def solve_lle_batch_rk45_torch(psi0, detuning, pump, lin_phase, *, dt: float, n_steps: int,
                               save_every: int, rtol: float, atol: float,
                               max_steps: int = 100_000,
                               method: str = "strang") -> SSFMAdaptiveResult:
    """Plain PyTorch version of :func:`solve_lle_batch_rk45_cuda`, on
    whatever device the tensors are; ``method='rk4ip'`` doubles RK4IP steps
    (``integrator='rk4ip45'``, no kernel).  The loop runs once per attempt
    of the slowest cavity."""
    check_cavities(psi0, detuning, pump, lin_phase, n_steps, save_every)
    _check_control(rtol, atol, max_steps)
    _rows, pk, y, ok, na, nr = lle_adaptive(
        psi0, detuning, pump, lin_phase, dt=dt, n_steps=n_steps, save_every=save_every,
        rtol=rtol, atol=atol, max_steps=max_steps, method=method)
    return SSFMAdaptiveResult(peak_max=pk, A_end=y, ok=ok, n_accepted=na, n_rejected=nr)


def solve_lle_batch_rk45_cuda(psi0, detuning, pump, lin_phase, *, dt: float, n_steps: int,
                              save_every: int, rtol: float, atol: float,
                              max_steps: int = 100_000) -> SSFMAdaptiveResult:
    """Solve B cavities adaptively (Strang step doubling, the affine LLE
    step) with the CUDA kernel, one thread block per cavity, in one launch.

    ``psi0`` is a ``(B, T)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor, T a multiple of 128 up to 2,048; ``detuning``
    ``(B,)`` real, ``pump`` ``(B,)`` complex, ``lin_phase`` ``(T,)`` or
    ``(B, T)`` real, of the matching dtypes on the same device.  The kernel
    forms each attempt's detuning rotations and drive offsets from Delta and
    F as the plain version does.  Returns without synchronizing."""
    B, T, rdt = check_cavities(psi0, detuning, pump, lin_phase, n_steps, save_every)
    _check_control(rtol, atol, max_steps)
    if psi0.device.type != "cuda":
        raise ValueError(
            f"solve_lle_batch_rk45_cuda needs CUDA tensors, got a tensor on {psi0.device}")
    why = width_problem("ssfm_rk45", T, rdt, psi0.device)
    if why is not None:
        raise ValueError(why)
    return _launch("ssfm_rk45_lle", psi0, detuning, pump, lin_phase, dt=dt, n_steps=n_steps,
                   save_every=save_every, rtol=rtol, atol=atol, max_steps=max_steps)
