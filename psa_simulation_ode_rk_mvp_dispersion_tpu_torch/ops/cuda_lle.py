"""The batched fixed-step LLE solve on the card: the CUDA kernel, its
wrapper, and the plain PyTorch version of the same function.

Counterpart of the JAX package's ``ops/pallas_lle.py`` (kernel K7: the K6
kernel ``ops/pallas_gnlse.py::_kernel_body`` built with ``affine=True``) and
of its scan path ``models/lle._lle_solver``.  The TPU kernel becomes the
hand-written CUDA template ``csrc/lle_ssfm.cu`` (radix-4 transforms with the
factor, the affine write and the Kerr rotation folded into their last
passes): float64 serves ``x64``/``df32``, float32 serves ``x32``.

- :func:`solve_lle_batch_cuda` checks its inputs, builds the dispersion and
  loss factors with the plain version's own ``models/lle._lle_lin_factor``
  (one shared row when the phase is ``(T,)``) and the per-cavity affine
  scalars (detuning rotation and drive offset for h/2 and h) in float64,
  launches one thread block per cavity on the current stream and counts the
  launch in ``ops/_build.LAUNCHES``.  It takes CUDA tensors only, and raises
  for a width the kernel does not take or a block that does not fit in the
  card's shared memory.
- :func:`solve_lle_batch_torch` is the plain version, ``models/lle.lle_fixed``,
  with ``torch.fft`` transforms.  The CPU path and the comparisons on the
  card use it; ``method='rk4ip'`` runs the interaction-picture steps, which
  have no kernel.

Both return ``ops/cuda_gnlse.GNLSEBatchResult``: the peak over the saved
samples, the field at the last saved grid point and ``ok``.  The kernel
computes its transforms itself, so the two agree to rounding.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cuda_gnlse import GNLSEBatchResult, twiddles, width_problem
from .cuda_solver import _COMPLEX_OF, _DTYPE_SUFFIX
from ..models.lle import _det_phase, _drive_offset, _lle_lin_factor, _scalar, lle_fixed
from ..utils.checks import device_key
from ..utils.observability import spanned


def check_cavities(psi0, detuning, pump, lin_phase, n_steps, save_every):
    """Validate a batch for the kernels and their plain versions: ``(B, T)``
    complex64/128 ``psi0``; ``detuning`` ``(B,)`` of the matching real
    dtype, ``pump`` ``(B,)`` of ``psi0``'s dtype, ``lin_phase`` ``(T,)`` or
    ``(B, T)`` real, all on ``psi0``'s device and contiguous.  Returns ``(B,
    T, real dtype)``."""
    if psi0.ndim != 2 or psi0.shape[0] < 1 or psi0.shape[1] < 2:
        raise ValueError(f"psi0 must have shape (B, T) with B >= 1, T >= 2, got "
                         f"{tuple(psi0.shape)}")
    B, T = psi0.shape
    rdt = psi0.real.dtype
    if rdt not in _COMPLEX_OF or psi0.dtype != _COMPLEX_OF[rdt]:
        raise ValueError(f"psi0 must be complex64 or complex128, got {psi0.dtype}")
    for name, v, shapes, dt in (("detuning", detuning, [(B,)], rdt),
                                ("pump", pump, [(B,)], psi0.dtype),
                                ("lin_phase", lin_phase, [(T,), (B, T)], rdt)):
        if tuple(v.shape) not in shapes or v.dtype != dt or v.device != psi0.device:
            raise ValueError(
                f"{name} must be a {' or '.join(map(str, shapes))} {dt} tensor on "
                f"{psi0.device}, got {tuple(v.shape)} {v.dtype} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_steps < 0 or save_every < 1:
        raise ValueError("need n_steps >= 0 and save_every >= 1")
    return B, T, rdt


@spanned("psa.k7.plain")
def solve_lle_batch_torch(psi0, detuning, pump, lin_phase, *, dt: float, n_steps: int,
                          save_every: int, method: str = "strang") -> GNLSEBatchResult:
    """Plain PyTorch version of :func:`solve_lle_batch_cuda`, on whatever
    device the tensors are."""
    check_cavities(psi0, detuning, pump, lin_phase, n_steps, save_every)
    _rows, pk, y, ok = lle_fixed(psi0, detuning, pump, lin_phase, dt=dt, n_steps=n_steps,
                                 save_every=save_every, method=method)
    return GNLSEBatchResult(peak_max=pk, A_end=y, ok=ok)


def factor_rows(lin_phase, dt: float, like: torch.Tensor):
    """``(Lh, Lf, stride)``: ``exp((-1 + i phi_d) h)`` for h = dt/2 and dt,
    as the plain version forms them, ``(1, T)`` (stride 0) for a shared
    phase, else ``(B, T)`` (stride T)."""
    h = _scalar(dt, like)
    ph = lin_phase[None] if lin_phase.ndim == 1 else lin_phase
    Lh = _lle_lin_factor(ph, 0.5 * h).contiguous()
    Lf = _lle_lin_factor(ph, h).contiguous()
    return Lh, Lf, (0 if Lh.shape[0] == 1 else like.shape[1])


def affine_scalars(detuning, pump, dt: float) -> torch.Tensor:
    """``(B, 4)`` complex128: the detuning rotation and the drive offset for
    h = dt/2 and dt, ``[dp_h, dF_h, dp_f, dF_f]``, computed in float64."""
    det = detuning.to(torch.float64)
    F = pump.to(torch.complex128)
    h = torch.tensor(float(dt), dtype=torch.float64, device=det.device)
    return torch.stack([_det_phase(det, 0.5 * h), _drive_offset(det, F, 0.5 * h),
                        _det_phase(det, h), _drive_offset(det, F, h)], dim=1)


def _launcher(rdt: torch.dtype):
    fn = getattr(_build.load_library("lle_ssfm"), f"lle_ssfm_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@spanned("psa.k7.launch")
def solve_lle_batch_cuda(psi0, detuning, pump, lin_phase, *, dt: float, n_steps: int,
                         save_every: int) -> GNLSEBatchResult:
    """Solve B cavities with the affine Strang split-step kernel, one thread
    block per cavity, in one launch.

    ``psi0`` is a ``(B, T)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor, T a multiple of 128 up to 2,048; ``detuning``
    ``(B,)`` real, ``pump`` ``(B,)`` complex, ``lin_phase`` ``(T,)`` or
    ``(B, T)`` real, of the matching dtypes on the same device.  A block
    holds 4 samples a thread up to T = 1,024 and 8 above.  Returns without
    synchronizing."""
    B, T, rdt = check_cavities(psi0, detuning, pump, lin_phase, n_steps, save_every)
    if psi0.device.type != "cuda":
        raise ValueError(f"solve_lle_batch_cuda needs CUDA tensors, got a tensor on {psi0.device}")
    why = width_problem("lle_ssfm", T, rdt, psi0.device)
    if why is not None:
        raise ValueError(why)
    dev = psi0.device
    Lh, Lf, stride = factor_rows(lin_phase, dt, psi0)
    aff = affine_scalars(detuning, pump, dt).to(psi0.dtype).contiguous()
    tw = twiddles(T, device_key(dev))
    y0 = psi0.contiguous()
    pk = torch.empty((B,), dtype=rdt, device=dev)
    y_last = torch.empty((B, T), dtype=psi0.dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    name = f"lle_ssfm_{_DTYPE_SUFFIX[rdt]}"
    with torch.cuda.device(dev):   # the C side reads the current card
        err = _launcher(rdt)(
            y0.data_ptr(), Lh.data_ptr(), Lf.data_ptr(), stride, aff.data_ptr(), tw.data_ptr(),
            pk.data_ptr(), y_last.data_ptr(), ok.data_ptr(), B, T, int(n_steps), int(save_every),
            float(dt), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[name] += 1
    return GNLSEBatchResult(peak_max=pk, A_end=y_last, ok=ok.bool())
