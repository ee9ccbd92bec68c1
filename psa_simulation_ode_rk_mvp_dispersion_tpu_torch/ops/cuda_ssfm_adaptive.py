"""The batched adaptive (rk45) GNLSE solve on the card: the CUDA kernel, its
wrapper, and the plain PyTorch version of the same function.

Counterpart of the GNLSE route of the JAX package's
``ops/pallas_ssfm_adaptive.py`` (kernel K8) and of its scan path
``models/gnlse._gnlse_adaptive_solver``.  The TPU kernel's GNLSE route
becomes the hand-written CUDA template ``csrc/ssfm_rk45.cu`` (Strang step
doubling, Kerr, flat per-lane loss; fp64 and fp32).

- :func:`solve_gnlse_batch_rk45_cuda` checks its inputs, launches one thread
  block per envelope on the current stream, every save segment and the
  trailing span in one launch, and counts the launch in
  ``ops/_build.LAUNCHES``.  CUDA tensors only.
- :func:`solve_gnlse_batch_rk45_torch` is the plain version,
  ``models/gnlse.gnlse_adaptive``, with ``torch.fft`` transforms; it also
  runs the calls the kernel does not take (``nl``, spectral loss,
  ``method='rk4ip'``).

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
from ..models.gnlse import NLTerms, gnlse_adaptive, save_segments


@dataclasses.dataclass(frozen=True)
class SSFMAdaptiveResult:
    """Per-envelope summaries, tensors on the solve's device (the
    counterpart of the JAX package's ``SSFMAdaptiveResult``)."""

    peak_max: torch.Tensor    # (B,) real: max over saved samples of max_t |A|^2 [W]
    A_end: torch.Tensor       # (B, T) complex: state at the last saved grid point
    ok: torch.Tensor          # (B,) bool
    n_accepted: torch.Tensor  # (B,) int32
    n_rejected: torch.Tensor  # (B,) int32


def _check_inputs(A0, gamma, alpha, lin_phase, n_steps, save_every, rtol, atol, max_steps):
    B, T, rdt = check_envelopes(A0, gamma, alpha, lin_phase, n_steps, save_every)
    if not (rtol > 0.0 and atol >= 0.0 and max_steps >= 1):
        raise ValueError("need rtol > 0, atol >= 0 and max_steps >= 1")
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


def _launcher(rdt: torch.dtype):
    fn = getattr(_build.load_library("ssfm_rk45"), f"ssfm_rk45_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_double] * 2 + [ctypes.c_int]
                   + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    dev = A0.device
    n_chunks, seg, z_end, has_tail = save_segments(dz_m, n_steps, save_every)
    tw = twiddles(T, str(dev))
    y0 = A0.contiguous()
    pk = torch.empty((B,), dtype=rdt, device=dev)
    y_last = torch.empty((B, T), dtype=A0.dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    na = torch.empty((B,), dtype=torch.int32, device=dev)
    nr = torch.empty((B,), dtype=torch.int32, device=dev)
    name = f"ssfm_rk45_{_DTYPE_SUFFIX[rdt]}"
    err = _launcher(rdt)(
        y0.data_ptr(), gamma.data_ptr(), alpha.data_ptr(), lin_phase.data_ptr(),
        0 if lin_phase.ndim == 1 else T, tw.data_ptr(), pk.data_ptr(), y_last.data_ptr(),
        ok.data_ptr(), na.data_ptr(), nr.data_ptr(), B, T, n_chunks, seg, z_end,
        int(has_tail), float(dz_m), float(rtol), float(atol), int(max_steps),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[name] += 1
    return SSFMAdaptiveResult(peak_max=pk, A_end=y_last, ok=ok.bool(), n_accepted=na,
                              n_rejected=nr)
