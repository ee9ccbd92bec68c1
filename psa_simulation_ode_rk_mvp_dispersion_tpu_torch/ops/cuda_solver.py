"""The batched 4-wave solve on the card: the CUDA kernel, its wrapper, and
the plain PyTorch version of the same function.

Counterpart of the JAX package's ``ops/pallas_df32.py`` (kernel K1, the
<=1e-9 tier) and ``ops/pallas_solver.py`` (kernel K2, the x32 tier).  Both
TPU kernels become one hand-written CUDA template, ``csrc/fwm4_rk.cu``:
float64 serves ``x64``/``df32``, float32 serves ``x32``, each with RK4, AB4
and ABM4.

- :func:`solve_batch_cuda` checks its inputs, lays them out as (rows, B)
  structure-of-arrays buffers, launches the kernel on the current stream
  and counts the launch in ``ops/_build.LAUNCHES``.  It takes CUDA tensors
  only.
- :func:`solve_batch_torch` is the plain version: the same rotating-frame
  integration through ``ops/integrators.integrate_reduce``, batched over
  ``(B, 4)`` complex tensors.  The CPU path and the comparisons on the card
  use it.

Both return the lab-frame state at the last saved z, ``z_last =
(n_steps // save_every) * save_every * dz`` (pallas_solver.py:275-281).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .integrators import integrate_reduce
from .rhs import RHSCoeffs, rhs_yaman_autonomous, rotating_to_lab

METHODS = ("rk4", "ab4", "abm4")
_DTYPE_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_COMPLEX_OF = {torch.float64: torch.complex128, torch.float32: torch.complex64}


@dataclasses.dataclass(frozen=True)
class KernelBatchResult:
    """Per-instance summaries, tensors on the solve's device."""

    P_max: torch.Tensor   # (B, 4) real: max power over the saved samples [W]
    A_end: torch.Tensor   # (B, 4) complex: lab-frame state at the last saved z
    ok: torch.Tensor      # (B,) bool: no non-finite state in any step


def check_lanes(A0, gamma, alpha, delta_beta, n_steps, save_every):
    """Validate a batch for the kernels: ``(B, 4)`` complex64/128 ``A0`` and
    ``(B,)`` coefficients of the matching real dtype on its device.
    Returns ``(B, real dtype)``."""
    if A0.ndim != 2 or A0.shape[1] != 4 or A0.shape[0] < 1:
        raise ValueError(f"A0 must have shape (B, 4) with B >= 1, got {tuple(A0.shape)}")
    B = A0.shape[0]
    rdt = A0.real.dtype
    if rdt not in _COMPLEX_OF or A0.dtype != _COMPLEX_OF[rdt]:
        raise ValueError(f"A0 must be complex64 or complex128, got {A0.dtype}")
    for name, v in (("gamma", gamma), ("alpha", alpha), ("delta_beta", delta_beta)):
        if v.shape != (B,) or v.dtype != rdt or v.device != A0.device:
            raise ValueError(
                f"{name} must be a ({B},) {rdt} tensor on {A0.device}, got "
                f"{tuple(v.shape)} {v.dtype} on {v.device}")
    if n_steps < 0 or save_every < 1:
        raise ValueError("need n_steps >= 0 and save_every >= 1")
    return B, rdt


def _check_inputs(A0, gamma, alpha, delta_beta, n_steps, save_every, integrator):
    B, rdt = check_lanes(A0, gamma, alpha, delta_beta, n_steps, save_every)
    if integrator not in METHODS:
        raise ValueError(f"integrator must be one of {METHODS}, got {integrator!r}")
    return B, rdt


def _to_lab(y_last, delta_beta, *, dz_m, n_steps, save_every):
    z_last = (int(n_steps) // int(save_every)) * int(save_every) * float(dz_m)
    return rotating_to_lab(z_last, y_last, RHSCoeffs(None, None, delta_beta))


def reduce_pmax_last(rhs, A0, coeffs: RHSCoeffs, *, dz_m: float, n_steps: int,
                     save_every: int, integrator: str = "rk4", check_nan: bool = True):
    """Integrate a ``(B, n)`` batch (4 waves, or N comb lines) with plain
    torch and keep the running max power and the last state over the save
    grid: ``(P_max, y_last, ok)``."""
    def fold(acc, y):
        pmax, _last = acc
        return torch.maximum(pmax, y.real * y.real + y.imag * y.imag), y

    P0 = A0.real * A0.real + A0.imag * A0.imag
    res = integrate_reduce(
        rhs, A0, coeffs, z0=0.0, dz=dz_m, n_steps=n_steps, save_every=save_every,
        reduce_init=(P0, A0), reduce_fn=fold, check_nan=check_nan,
        method=integrator, batch_ndim=1,
    )
    pmax, y_last = res.reduction
    return pmax, y_last, res.ok


def solve_batch_torch(A0, gamma, alpha, delta_beta, *, dz_m: float, n_steps: int,
                      save_every: int, integrator: str = "rk4",
                      check_nan: bool = True) -> KernelBatchResult:
    """Plain PyTorch version of :func:`solve_batch_cuda`: the same
    rotating-frame integration, NaN freeze and save-grid reductions, on
    whatever device the tensors are."""
    _check_inputs(A0, gamma, alpha, delta_beta, n_steps, save_every, integrator)
    pmax, y_last, ok = reduce_pmax_last(
        rhs_yaman_autonomous, A0, RHSCoeffs(gamma, alpha, delta_beta), dz_m=dz_m,
        n_steps=n_steps, save_every=save_every, integrator=integrator, check_nan=check_nan,
    )
    return KernelBatchResult(
        P_max=pmax,
        A_end=_to_lab(y_last, delta_beta, dz_m=dz_m, n_steps=n_steps, save_every=save_every),
        ok=ok,
    )


def _launcher(rdt: torch.dtype, integrator: str):
    fn = getattr(_build.load_library("fwm4_rk"), f"fwm4_{integrator}_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def solve_batch_cuda(A0, gamma, alpha, delta_beta, *, dz_m: float, n_steps: int,
                     save_every: int, integrator: str = "rk4",
                     check_nan: bool = True) -> KernelBatchResult:
    """Solve B rotating-frame instances with the CUDA kernel.

    ``A0`` is a ``(B, 4)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor; ``gamma``, ``alpha`` and ``delta_beta`` are ``(B,)``
    tensors of the matching real dtype on the same device.  With
    ``check_nan`` false no lane is frozen and ``ok`` stays set.  Returns
    without synchronizing; the outputs are ordinary tensors on the stream.
    """
    B, rdt = _check_inputs(A0, gamma, alpha, delta_beta, n_steps, save_every, integrator)
    if A0.device.type != "cuda":
        raise ValueError(f"solve_batch_cuda needs CUDA tensors, got a tensor on {A0.device}")
    coef = torch.stack([gamma, alpha, delta_beta])                # (3, B)
    y0 = torch.cat([A0.real.T, A0.imag.T]).contiguous()           # (8, B)
    pmax = torch.empty((4, B), dtype=rdt, device=A0.device)
    y_last = torch.empty((8, B), dtype=rdt, device=A0.device)
    ok = torch.empty((B,), dtype=torch.uint8, device=A0.device)
    for t in (coef, y0):
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    fn = _launcher(rdt, integrator)
    err = fn(coef.data_ptr(), y0.data_ptr(), pmax.data_ptr(), y_last.data_ptr(),
             ok.data_ptr(), B, int(n_steps), int(save_every), int(bool(check_nan)), float(dz_m),
             torch.cuda.current_stream(A0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fwm4_{integrator}_{_DTYPE_SUFFIX[rdt]} launch failed: "
                           f"cudaError {err}")
    _build.LAUNCHES[f"fwm4_rk_{_DTYPE_SUFFIX[rdt]}"] += 1
    A_rot = torch.complex(y_last[:4].T, y_last[4:].T)
    return KernelBatchResult(
        P_max=pmax.T,
        A_end=_to_lab(A_rot, delta_beta, dz_m=dz_m, n_steps=n_steps, save_every=save_every),
        ok=ok.bool(),
    )
