"""The batched fixed-step vector GNLSE solve on the card: the CUDA kernel, its
wrapper, and the plain PyTorch version of the same function.

Counterpart of the JAX package's ``ops/pallas_vgnlse.py`` (kernel K9) and of
its scan path ``models/vgnlse._vgnlse_solver``.  The TPU kernel becomes the
hand-written CUDA template ``csrc/vgnlse_ssfm.cu``: float64 serves
``x64``/``df32``, float32 serves ``x32``, each with one of three nonlinear
bodies (:func:`body_of`): the exact joint rotation (``'rotation'``, the
cnlse and manakov couplings), the pointwise RK4 on the coherent operator
(``'coherent'``, the isotropic coupling), or the RK4 on the isotropic-Raman
and self-steepening operator (``'nl'``, any coupling with ``nl=``; its own
kernel in the same source, ``vgnlse_nl_kernel``: the RK4 sums in registers
and wide radix-4 transforms).

- :func:`solve_vgnlse_batch_cuda` checks its inputs, builds the linear
  factors with the plain version's own ``models/vgnlse._lin_factor_v`` (one
  shared ``(2, T)`` plane when every instance has the same loss and phase),
  launches one thread block per instance on the current stream and counts
  the launch in ``ops/_build.LAUNCHES`` by body: ``vgnlse_ssfm_f64``/``_f32``
  for the rotation, ``vgnlse_ssfm_coherent_*`` and ``vgnlse_ssfm_nl_*``.
  It takes CUDA tensors only, and raises for a width it does not take or a
  block that does not fit in the card's shared memory.
- :func:`solve_vgnlse_batch_torch` is the plain version,
  ``models/vgnlse.vgnlse_fixed``, with ``torch.fft`` transforms.  The CPU
  path and the comparisons on the card use it.

Widths the kernel takes: T a multiple of 128 up to 2,048 (the JAX kernel's),
whose block fits in the card's shared memory (:func:`shared_bytes`): on an
H100 (232,448 bytes a block) every such T for every body, in fp64 and fp32
(the widest, fp64 ``nl`` at T = 2,048, takes 196,864 bytes).
``models/vgnlse.solve_vgnlse_batch`` sends any other call to the plain
version under ``engine='auto'`` and raises under ``engine='cuda'``, decided
before any launch.

Both return the per-polarization peak over the saved samples, the state at
the last saved grid point and ``ok``.  The kernel computes its transforms
itself, so the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from . import _build
from .cuda_gnlse import MAX_WIDTH, REDUCE_SLOTS, WIDTH_QUANTUM, twiddles
from .cuda_solver import _COMPLEX_OF, _DTYPE_SUFFIX
from ..models.gnlse import NLTerms, _scalar
from ..models.vgnlse import _lin_factor_v, vgnlse_fixed
from ..utils.checks import device_key

# The nonlinear bodies of csrc/vgnlse_ssfm.cu (its Body enum), and the
# buffers of T complex values a block of each keeps in shared memory: the
# state and its transform partner, both polarizations; nl the state and a
# transform pair (its RK4 sums are registers).
BODIES = {"rotation": 0, "coherent": 1, "nl": 2}
SHARED_BUFFERS = {"rotation": 4, "coherent": 4, "nl": 6}


@dataclasses.dataclass(frozen=True)
class VGNLSEBatchResult:
    """Per-instance summaries, tensors on the solve's device."""

    peak_max: torch.Tensor   # (B, 2) real: max over saved samples of max_t |A_p|^2 [W]
    A_end: torch.Tensor      # (B, 2, T) complex: state at the last saved grid point
    ok: torch.Tensor         # (B,) bool


def body_of(coherent: float, nl) -> str:
    """The kernel body a call runs: ``'nl'`` with nonlinear terms, else
    ``'coherent'`` for a coherent coupling, else ``'rotation'``."""
    if nl is not None:
        return "nl"
    return "coherent" if float(coherent) != 0.0 else "rotation"


def shared_bytes(T: int, rdt: torch.dtype, body: str) -> int:
    """Bytes of shared memory one block of ``body`` takes at width T
    (``vgnlse_ssfm_shared_bytes`` of the CUDA source)."""
    elem = torch.finfo(rdt).bits // 8
    return elem * (REDUCE_SLOTS + 2 * SHARED_BUFFERS[body] * int(T))


def shared_memory_problem(T: int, rdt: torch.dtype, body: str, limit: int) -> Optional[str]:
    """Why one block of ``body`` at width T does not fit in ``limit`` bytes
    of shared memory (the card's opt-in limit a block), or None."""
    need = shared_bytes(T, rdt, body)
    if need <= limit:
        return None
    return (f"T={T} needs {need} bytes of shared memory per block in vgnlse_ssfm "
            f"({'fp64' if rdt == torch.float64 else 'fp32'}, {body} body); this card allows "
            f"{limit}: use engine='torch'")


def width_problem(T: int, rdt: torch.dtype, device: torch.device, body: str) -> Optional[str]:
    """Why the kernel does not take width T on ``device`` (the JAX
    package's messages for the widths), or None when it does."""
    if T % WIDTH_QUANTUM != 0 or T < WIDTH_QUANTUM:
        return (f"T={T} is not a multiple of {WIDTH_QUANTUM}: the fused vector SSFM kernel "
                f"needs polyphase groups of {WIDTH_QUANTUM}; use the torch engine")
    if T > MAX_WIDTH:
        return (f"T={T} too wide for the fused vector SSFM kernel (max {MAX_WIDTH}); use the "
                "torch engine")
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    return shared_memory_problem(T, rdt, body, limit)


def check_instances(A0, gamma, alpha, b_xpm, lin_phase, n_steps, save_every):
    """Validate a batch for the kernel and its plain version: ``(B, 2, T)``
    complex64/128 ``A0``; ``gamma`` ``(B,)``; ``alpha`` ``(B,)`` (flat),
    ``(2, T)`` or ``(B, 2, T)`` (spectral); ``b_xpm`` 0-d; ``lin_phase``
    ``(2, T)`` or ``(B, 2, T)``; all of the matching real dtype on its
    device and contiguous.  Returns ``(B, T, real dtype)``."""
    if A0.ndim != 3 or A0.shape[0] < 1 or A0.shape[1] != 2 or A0.shape[2] < 2:
        raise ValueError(f"A0 must have shape (B, 2, T) with B >= 1, T >= 2, got "
                         f"{tuple(A0.shape)}")
    B, _, T = A0.shape
    rdt = A0.real.dtype
    if rdt not in _COMPLEX_OF or A0.dtype != _COMPLEX_OF[rdt]:
        raise ValueError(f"A0 must be complex64 or complex128, got {A0.dtype}")
    for name, v, shapes in (("gamma", gamma, [(B,)]),
                            ("alpha", alpha, [(B,), (2, T), (B, 2, T)]),
                            ("b_xpm", b_xpm, [()]),
                            ("lin_phase", lin_phase, [(2, T), (B, 2, T)])):
        if tuple(v.shape) not in shapes or v.dtype != rdt or v.device != A0.device:
            raise ValueError(
                f"{name} must be a {' or '.join(map(str, shapes))} {rdt} tensor on {A0.device}, "
                f"got {tuple(v.shape)} {v.dtype} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_steps < 0 or save_every < 1:
        raise ValueError("need n_steps >= 0 and save_every >= 1")
    return B, T, rdt


def solve_vgnlse_batch_torch(A0, gamma, alpha, b_xpm, lin_phase, coherent: float = 0.0, *,
                             dz_m: float, n_steps: int, save_every: int,
                             nl: Optional[NLTerms] = None,
                             method: str = "strang") -> VGNLSEBatchResult:
    """Plain PyTorch version of :func:`solve_vgnlse_batch_cuda`, on whatever
    device the tensors are; ``method='rk4ip'`` runs the interaction-picture
    RK4 steps instead (no kernel)."""
    check_instances(A0, gamma, alpha, b_xpm, lin_phase, n_steps, save_every)
    _rows, pk, y, ok = vgnlse_fixed(A0, gamma, alpha, b_xpm, lin_phase, coherent, dz_m=dz_m,
                                    n_steps=n_steps, save_every=save_every, nl=nl,
                                    method=method)
    return VGNLSEBatchResult(peak_max=pk, A_end=y, ok=ok)


def factor_planes(alpha, lin_phase, dz_m: float, like: torch.Tensor):
    """``(Lh, Lf, stride)``: the factors exp((-alpha/2 + i phi_p) h) for h =
    dz/2 and dz as the plain version forms them, one shared ``(2, T)``
    plane (stride 0) when the phase is shared and the loss is one flat
    value or one shared spectral plane, else ``(B, 2, T)`` (stride 2T)."""
    B, _, T = like.shape
    if lin_phase.ndim == 2:
        if alpha.ndim == 1 and bool((alpha == alpha[0]).all()):
            alpha = alpha[:1]
        if alpha.ndim == 2 or alpha.shape == (1,):
            h = _scalar(dz_m, like)
            Lh = _lin_factor_v(alpha, lin_phase, 0.5 * h).reshape(2, T).contiguous()
            Lf = _lin_factor_v(alpha, lin_phase, h).reshape(2, T).contiguous()
            return Lh, Lf, 0
    h = _scalar(dz_m, like)
    Lh = _lin_factor_v(alpha, lin_phase, 0.5 * h).broadcast_to((B, 2, T)).contiguous()
    Lf = _lin_factor_v(alpha, lin_phase, h).broadcast_to((B, 2, T)).contiguous()
    return Lh, Lf, 2 * T


def _launcher(rdt: torch.dtype):
    fn = getattr(_build.load_library("vgnlse_ssfm"), f"vgnlse_ssfm_{_DTYPE_SUFFIX[rdt]}")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 5 + [ctypes.c_double] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def solve_vgnlse_batch_cuda(A0, gamma, alpha, b_xpm, lin_phase, coherent: float = 0.0, *,
                            dz_m: float, n_steps: int, save_every: int,
                            nl: Optional[NLTerms] = None) -> VGNLSEBatchResult:
    """Solve B vector instances with the Strang split-step kernel, one thread
    block per instance, in one launch.

    ``A0`` is a ``(B, 2, T)`` complex128 (fp64 kernel) or complex64 (fp32
    kernel) CUDA tensor; ``gamma`` ``(B,)``, ``alpha`` ``(B,)``, ``(2, T)``
    or ``(B, 2, T)``, ``b_xpm`` 0-d, ``lin_phase`` ``(2, T)`` or ``(B, 2,
    T)`` of the matching real dtype on the same device; ``coherent`` the
    four-wave ratio c.  ``nl`` (tensors of that dtype on that device) selects
    the generalized body.  Returns without synchronizing."""
    B, T, rdt = check_instances(A0, gamma, alpha, b_xpm, lin_phase, n_steps, save_every)
    if A0.device.type != "cuda":
        raise ValueError(f"solve_vgnlse_batch_cuda needs CUDA tensors, got a tensor on "
                         f"{A0.device}")
    body = body_of(coherent, nl)
    why = width_problem(T, rdt, A0.device, body)
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
    pk = torch.empty((B, 2), dtype=rdt, device=dev)
    y_last = torch.empty((B, 2, T), dtype=A0.dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):   # the C side reads the current card
        err = _launcher(rdt)(
            y0.data_ptr(), Lh.data_ptr(), Lf.data_ptr(), stride, gamma.data_ptr(), tw.data_ptr(),
            hrc.data_ptr(), omega.data_ptr(), pk.data_ptr(), y_last.data_ptr(), ok.data_ptr(), B, T,
            int(n_steps), int(save_every), BODIES[body], float(dz_m), float(b_xpm),
            float(coherent), f_r, inv_w0, torch.cuda.current_stream(dev).cuda_stream)
    name = f"vgnlse_ssfm{'' if body == 'rotation' else '_' + body}_{_DTYPE_SUFFIX[rdt]}"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _build.LAUNCHES[name] += 1
    return VGNLSEBatchResult(peak_max=pk, A_end=y_last, ok=ok.bool())
