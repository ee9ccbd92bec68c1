"""The batched fixed-step GNLSE solve on the card: the CUDA kernel, its
wrapper, and the plain PyTorch version of the same function.

Counterpart of the JAX package's ``ops/pallas_gnlse.py`` (kernel K6) and of
its scan path ``models/gnlse._gnlse_reduce_solver``.  The TPU kernel becomes
the hand-written CUDA template ``csrc/gnlse_ssfm.cu``: float64 serves
``x64``/``df32``, float32 serves ``x32``, each with the exact Kerr rotation or
the RK4 on the Raman/self-steepening operator (its own kernel in the same
source, ``gnlse_nl_kernel``: the RK4 sums in registers and wide radix-4
transforms).

- :func:`solve_gnlse_batch_cuda` checks its inputs, builds the linear
  factors with the plain version's own ``models/gnlse._lin_factor`` (one
  shared row when every envelope has the same flat loss and phase), launches
  one thread block per envelope on the current stream and counts the launch
  in ``ops/_build.LAUNCHES`` by route: ``gnlse_ssfm_f64``/``_f32`` for Kerr,
  ``gnlse_ssfm_nl_f64``/``_f32`` for the nonlinear terms.  It takes CUDA
  tensors only, and raises for a width the kernel does not take or a block
  that does not fit in the card's shared memory.
- :func:`solve_gnlse_batch_torch` is the plain version,
  ``models/gnlse.gnlse_fixed``, with ``torch.fft`` transforms.  The CPU path
  and the comparisons on the card use it.

Both return the peak over the saved samples, the state at the last saved
grid point and ``ok``.  The kernel computes its transforms itself (Stockham
FFTs in shared memory), so the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import _build
from .cuda_solver import _COMPLEX_OF, _DTYPE_SUFFIX
from ..models.gnlse import NLTerms, _lin_factor, _scalar, gnlse_fixed
from ..utils.checks import device_key
from ..utils.observability import spanned

# The widths the kernels take, those of the JAX kernels: T a multiple of 128,
# at most 128 * 16.
WIDTH_QUANTUM = 128
MAX_WIDTH = 128 * 16
# Buffers of T complex values a block keeps in shared memory, and the
# reduction slots beside them (csrc/gnlse_ssfm.cu, csrc/lle_ssfm.cu,
# csrc/ssfm_rk45.cu): Kerr and the LLE the state and its transform partner
# (the LLE's factors are registers); nl the state and a transform pair (its
# RK4 sums are registers); rk45 the state, a transform pair and the fine
# spectrum (its factors and coarse state are registers).
SHARED_BUFFERS = {("gnlse_ssfm", False): 2, ("gnlse_ssfm", True): 3, ("lle_ssfm", False): 2,
                  ("ssfm_rk45", False): 4}
REDUCE_SLOTS = 32


@dataclasses.dataclass(frozen=True)
class GNLSEBatchResult:
    """Per-envelope summaries, tensors on the solve's device."""

    peak_max: torch.Tensor   # (B,) real: max over saved samples of max_t |A|^2 [W]
    A_end: torch.Tensor      # (B, T) complex: state at the last saved grid point
    ok: torch.Tensor         # (B,) bool


def shared_bytes(kernel: str, T: int, rdt: torch.dtype, nl: bool = False) -> int:
    """Bytes of shared memory one block of ``kernel`` takes at width T (the
    ``*_shared_bytes`` functions of the CUDA sources)."""
    elem = torch.finfo(rdt).bits // 8
    return elem * (REDUCE_SLOTS + 2 * SHARED_BUFFERS[(kernel, nl)] * int(T))


def shared_memory_problem(kernel: str, T: int, rdt: torch.dtype, nl: bool,
                          limit: int) -> Optional[str]:
    """Why one block of ``kernel`` at width T does not fit in ``limit``
    bytes of shared memory (the card's opt-in limit a block), or None."""
    need = shared_bytes(kernel, T, rdt, nl)
    if need <= limit:
        return None
    return (f"T={T} needs {need} bytes of shared memory per block in {kernel} "
            f"({'fp64' if rdt == torch.float64 else 'fp32'}{', nl' if nl else ''}); this card "
            f"allows {limit}: use engine='torch'")


def width_problem(kernel: str, T: int, rdt: torch.dtype, device: torch.device,
                  nl: bool = False) -> Optional[str]:
    """Why ``kernel`` does not take width T on ``device`` (the JAX
    package's messages for the widths), or None when it does."""
    if kernel == "ssfm_rk45":
        if T % WIDTH_QUANTUM != 0 or T < WIDTH_QUANTUM or T > MAX_WIDTH:
            return (f"T={T} must be a multiple of {WIDTH_QUANTUM} and at most {MAX_WIDTH} for "
                    "the fused adaptive SSFM kernel; use engine='torch'")
    elif T % WIDTH_QUANTUM != 0 or T < WIDTH_QUANTUM:
        return (f"T={T} is not a multiple of {WIDTH_QUANTUM}: the fused SSFM kernel needs "
                f"polyphase groups of {WIDTH_QUANTUM}; use the torch engine")
    elif T > MAX_WIDTH:
        return (f"T={T} too wide for the fused SSFM kernel (max {MAX_WIDTH}); use the torch "
                "engine")
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    return shared_memory_problem(kernel, T, rdt, nl, limit)


def check_envelopes(A0, gamma, alpha, lin_phase, n_steps, save_every):
    """Validate a batch for the kernels and their plain versions: ``(B, T)``
    complex64/128 ``A0``; ``gamma`` ``(B,)``; ``alpha`` ``(B,)`` (flat) or
    ``(B, T)`` (spectral); ``lin_phase`` ``(T,)`` or ``(B, T)``; all of the
    matching real dtype on its device and contiguous.  Returns ``(B, T, real
    dtype)``."""
    if A0.ndim != 2 or A0.shape[0] < 1 or A0.shape[1] < 2:
        raise ValueError(f"A0 must have shape (B, T) with B >= 1, T >= 2, got {tuple(A0.shape)}")
    B, T = A0.shape
    rdt = A0.real.dtype
    if rdt not in _COMPLEX_OF or A0.dtype != _COMPLEX_OF[rdt]:
        raise ValueError(f"A0 must be complex64 or complex128, got {A0.dtype}")
    for name, v, shapes in (("gamma", gamma, [(B,)]), ("alpha", alpha, [(B,), (B, T)]),
                            ("lin_phase", lin_phase, [(T,), (B, T)])):
        if tuple(v.shape) not in shapes or v.dtype != rdt or v.device != A0.device:
            raise ValueError(
                f"{name} must be a {' or '.join(map(str, shapes))} {rdt} tensor on {A0.device}, "
                f"got {tuple(v.shape)} {v.dtype} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_steps < 0 or save_every < 1:
        raise ValueError("need n_steps >= 0 and save_every >= 1")
    return B, T, rdt


@spanned("psa.k6.plain")
def solve_gnlse_batch_torch(A0, gamma, alpha, lin_phase, *, dz_m: float, n_steps: int,
                            save_every: int, nl: Optional[NLTerms] = None,
                            method: str = "strang") -> GNLSEBatchResult:
    """Plain PyTorch version of :func:`solve_gnlse_batch_cuda`, on whatever
    device the tensors are; ``method='rk4ip'`` runs the interaction-picture
    RK4 steps instead (no kernel)."""
    check_envelopes(A0, gamma, alpha, lin_phase, n_steps, save_every)
    _rows, pk, y, ok = gnlse_fixed(A0, gamma, alpha, lin_phase, dz_m=dz_m, n_steps=n_steps,
                                   save_every=save_every, nl=nl, method=method)
    return GNLSEBatchResult(peak_max=pk, A_end=y, ok=ok)


@functools.lru_cache(maxsize=16)
def twiddles(T: int, device: str) -> torch.Tensor:
    """The SSFM kernels' float64 ``(T, 2)`` table of ``(cos, sin)(2 pi k /
    T)``.  Both instantiations use it unrounded: their transforms multiply
    and add in double and round each pass's output to the kernel's type,
    since a float32 table's fixed rounding would bias every transform pair
    alike, an error that grows linearly over the steps."""
    ang = (2.0 * np.pi / T) * np.arange(T)
    return torch.as_tensor(np.stack([np.cos(ang), np.sin(ang)], axis=1), device=device)


def factor_planes(alpha, lin_phase, dz_m: float, like: torch.Tensor):
    """``(Lh, Lf, stride)``: the factors exp((-alpha/2 + i phi) h) for h =
    dz/2 and dz as the plain version forms them, one shared ``(T,)`` row
    (stride 0) when every envelope has the same flat loss and the phase is
    shared, else ``(B, T)`` (stride T)."""
    T = like.shape[1]
    if alpha.ndim == 1 and lin_phase.ndim == 1 and bool((alpha == alpha[0]).all()):
        alpha = alpha[:1]
    h = _scalar(dz_m, like)
    Lh = _lin_factor(alpha, lin_phase, 0.5 * h).contiguous()
    Lf = _lin_factor(alpha, lin_phase, h).contiguous()
    return Lh, Lf, (0 if Lh.shape[0] == 1 else T)


def _launcher(rdt: torch.dtype):
    fn = getattr(_build.load_library("gnlse_ssfm"), f"gnlse_ssfm_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 5 + [ctypes.c_double] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@spanned("psa.k6.launch")
def solve_gnlse_batch_cuda(A0, gamma, alpha, lin_phase, *, dz_m: float, n_steps: int,
                           save_every: int, nl: Optional[NLTerms] = None) -> GNLSEBatchResult:
    """Solve B envelopes with the Strang split-step kernel, one thread block
    per envelope, in one launch.

    ``A0`` is a ``(B, T)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor, T a multiple of 128 up to 2,048; ``gamma`` ``(B,)``,
    ``alpha`` ``(B,)`` or ``(B, T)``, ``lin_phase`` ``(T,)`` or ``(B, T)`` of
    the matching real dtype on the same device.  ``nl`` (tensors of that
    dtype on that device) switches the nonlinear substep to the RK4 on the
    generalized operator.  Returns without synchronizing."""
    B, T, rdt = check_envelopes(A0, gamma, alpha, lin_phase, n_steps, save_every)
    if A0.device.type != "cuda":
        raise ValueError(f"solve_gnlse_batch_cuda needs CUDA tensors, got a tensor on {A0.device}")
    why = width_problem("gnlse_ssfm", T, rdt, A0.device, nl=nl is not None)
    if why is not None:
        raise ValueError(why)
    dev = A0.device
    Lh, Lf, stride = factor_planes(alpha, lin_phase, dz_m, A0)
    tw = twiddles(T, device_key(dev))
    if nl is not None:
        hrc = torch.complex(nl.hr_re, -nl.hr_im).to(dev).contiguous()
        omega = nl.omega.to(dev, rdt).contiguous()
        f_r, inv_w0 = float(nl.f_r), float(nl.inv_w0)
    else:
        hrc, omega, f_r, inv_w0 = tw, tw, 0.0, 0.0        # not read
    y0 = A0.contiguous()
    pk = torch.empty((B,), dtype=rdt, device=dev)
    y_last = torch.empty((B, T), dtype=A0.dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):   # the C side reads the current card
        err = _launcher(rdt)(
            y0.data_ptr(), Lh.data_ptr(), Lf.data_ptr(), stride, gamma.data_ptr(), tw.data_ptr(),
            hrc.data_ptr(), omega.data_ptr(), pk.data_ptr(), y_last.data_ptr(), ok.data_ptr(), B, T,
            int(n_steps), int(save_every), int(nl is not None), float(dz_m), f_r, inv_w0,
            torch.cuda.current_stream(dev).cuda_stream)
    name = f"gnlse_ssfm{'_nl' if nl is not None else ''}_{_DTYPE_SUFFIX[rdt]}"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[name] += 1
    return GNLSEBatchResult(peak_max=pk, A_end=y_last, ok=ok.bool())
