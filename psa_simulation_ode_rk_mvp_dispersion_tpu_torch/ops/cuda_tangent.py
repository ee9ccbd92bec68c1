"""The 4-wave RK4 in tangent (forward) mode on the card: the CUDA kernel, its
wrapper, the plain PyTorch version of the same function, and the
``torch.autograd.Function`` that the calibration layer
(``parallel/calibrate``) differentiates through.

No TPU kernel of the JAX package computes this.  There, ``jax.grad`` of the
``lax.scan`` RK4 (``parallel/calibrate.py:154-167``, ``:698-711``)
differentiates the whole integration as one XLA program.  Its counterpart
here is ``csrc/fwm4_tangent.cu``: a fit has 3 parameters (gamma, alpha and
delta beta) and a launch transfer 8 input directions (the real and
imaginary parts of the 4 waves), so forward mode -- one tangent per
direction, carried beside the state -- costs less than a reverse-mode tape
and gives the exact derivative of the same discrete RK4 map.  A fit's step
is then one launch.

The contract is ``ops/integrators.integrate_reduce`` with
``check_nan=False`` and ``save_every = n_steps`` (JAX ``calibrate.py:156-166``):
the rotating-frame RK4 (``ops/rhs.rhs_yaman_autonomous``) over ``n_steps``
steps from ``y0``, no NaN freeze, the state after the last step.  A
direction is an initial tangent ``t0`` of the state and a seed ``s`` over
the coefficients (gamma, alpha, delta_beta); its tangent obeys ``dt/dz =
J(y) t + sum_k s_k df/dtheta_k``, stepped with the same RK4 stages as the
state.  Fit directions are ``t0 = 0``, ``s = e_k``; launch directions
``t0 = e_q``, ``s = 0``.

Layout: structure of arrays, row k of a ``(rows, n)`` buffer at ``k * n``.
With B lanes and D directions, column ``i = d * B + b`` is direction d of
lane b:

- ``coef (3, B)``: gamma, alpha, delta_beta;
- ``y0 (8, B)``: re(A1..A4), im(A1..A4);
- ``t0 (8, B*D)``, ``s (3, B*D)``;
- out ``y_end (8, B)``, ``t_end (8, B*D)``.

- :func:`solve_tangent_cuda` checks its inputs, launches the kernel on the
  current stream and counts the launch in ``ops/_build.LAUNCHES``
  (``fwm4_tangent_f64`` / ``_f32``, whichever design the width takes).  It
  takes CUDA tensors only.  :func:`solve_tangent_design` runs one design
  (a (lane, direction) on 1 thread or on 4) and counts nothing: the holds
  and the A/B of ``chip_smoke.py`` phase 29 use it.
- :func:`solve_tangent_torch` is the plain version: the state by the
  operations of ``ops/integrators._rk4_increment`` (so it follows
  ``integrate_reduce`` to the bit), the tangent by the RK4 stages of the
  RHS's derivative, :func:`rhs_tangent`; in float32 the state's increment
  is added with compensated (Kahan) summation, the tangent's plainly, as
  the kernel does.
- :func:`solve_tangent` takes the kernel for CUDA tensors and the plain
  version for CPU tensors; there is no fallback.
- :func:`rk4_end_state` is the differentiable end state: an autograd
  Function whose forward launches only the directions its inputs need
  gradients for (3 for the coefficients, 8 for the initial state) and
  saves their Jacobian, and whose backward contracts with it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cuda_solver import _DTYPE_SUFFIX
from .rhs import RHSCoeffs, rhs_yaman_autonomous
from ..utils.observability import spanned

N_COEF = 3    # gamma, alpha, delta_beta
N_STATE = 8   # re and im of the 4 waves


@functools.lru_cache(maxsize=32)
def directions(B: int, *, coef: bool, state: bool, dtype: torch.dtype, device):
    """The seeds ``(t0 (8, B*D), s (3, B*D))`` of the fit directions (one a
    coefficient, ``s = e_k``) and the launch directions (one a real
    component of the initial state, ``t0 = e_q``), in that order.  Made
    once for each shape and device (a fit asks for the same every step):
    read them, never write them."""
    eye = []
    if coef:
        eye += [(None, k) for k in range(N_COEF)]
    if state:
        eye += [(q, None) for q in range(N_STATE)]
    D = len(eye)
    t0 = torch.zeros((N_STATE, D, B), dtype=dtype, device=device)
    s = torch.zeros((N_COEF, D, B), dtype=dtype, device=device)
    for d, (q, k) in enumerate(eye):
        if q is not None:
            t0[q, d] = 1.0
        if k is not None:
            s[k, d] = 1.0
    return t0.reshape(N_STATE, D * B), s.reshape(N_COEF, D * B)


def _check(coef, y0, t0, s, n_steps):
    """Validate the planes; returns ``(B, D, real dtype)``."""
    if coef.ndim != 2 or coef.shape[0] != N_COEF or coef.shape[1] < 1:
        raise ValueError(f"coef must have shape (3, B) with B >= 1, got {tuple(coef.shape)}")
    B, rdt = coef.shape[1], coef.dtype
    if rdt not in _DTYPE_SUFFIX:
        raise ValueError(f"coef must be float64 or float32, got {rdt}")
    if y0.shape != (N_STATE, B):
        raise ValueError(f"y0 must have shape (8, {B}), got {tuple(y0.shape)}")
    if t0.ndim != 2 or t0.shape[0] != N_STATE or t0.shape[1] % B or t0.shape[1] < B:
        raise ValueError(f"t0 must have shape (8, {B} * D) with D >= 1, got {tuple(t0.shape)}")
    if s.shape != (N_COEF, t0.shape[1]):
        raise ValueError(f"s must have shape (3, {t0.shape[1]}), got {tuple(s.shape)}")
    for name, t in (("y0", y0), ("t0", t0), ("s", s)):
        if t.dtype != rdt or t.device != coef.device:
            raise ValueError(f"{name} must be {rdt} on {coef.device}, got {t.dtype} on "
                             f"{t.device}")
    if n_steps < 0:
        raise ValueError("need n_steps >= 0")
    return B, t0.shape[1] // B, rdt


# wave j's FWM partner (conjugated), the pair whose product drives it, and
# the pumps, which carry the detuning
_PARTNER = (1, 0, 3, 2)
_PAIR = ((2, 2, 0, 0), (3, 3, 1, 1))
_PUMP = (1.0, 1.0, 0.0, 0.0)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype):
    """The index and pump tables of :func:`rhs_tangent`, made once a device."""
    return (*(torch.tensor(i, device=device) for i in (_PARTNER,) + _PAIR),
            torch.tensor(_PUMP, dtype=dtype, device=device))


def rhs_tangent(b, u, p: RHSCoeffs, s: RHSCoeffs):
    """The derivative of ``ops/rhs.rhs_yaman_autonomous`` at the state ``b``
    along the state direction ``u`` and the coefficient seeds ``s`` (the
    same ``(N, 4)`` complex and ``(N,)`` real shapes): with the Kerr factor
    ``F_j = 2 sum(P) - P_j`` and the FWM drive ``K_j = F_j b_j + 2 conj(b_p)
    b_l b_h``, ``f_j = -alpha/2 b_j + i gamma K_j - i (delta_beta/2) b_j``
    (the last on the pumps), so ``df_j = -alpha/2 u_j - s_alpha/2 b_j +
    i (s_gamma K_j + gamma dK_j) - i/2 (delta_beta u_j + s_delta_beta b_j)``."""
    col = [c[:, None] for c in (p.gamma, p.alpha, p.delta_beta, s.gamma, s.alpha,
                                s.delta_beta)]
    g, al, db, sg, sa, sd = col
    P = b.real * b.real + b.imag * b.imag
    dP = 2.0 * (b.real * u.real + b.imag * u.imag)
    F = 2.0 * P.sum(dim=-1, keepdim=True) - P
    dF = 2.0 * dP.sum(dim=-1, keepdim=True) - dP
    part, lo, hi, pump = _tables(b.device, P.dtype)
    bp, up = b[:, part].conj(), u[:, part].conj()
    S = b[:, lo] * b[:, hi]
    dS = u[:, lo] * b[:, hi] + b[:, lo] * u[:, hi]
    K = F * b + 2.0 * (bp * S)
    dK = dF * b + F * u + 2.0 * (up * S + bp * dS)
    return (-0.5 * al * u - 0.5 * sa * b + 1j * (sg * K + g * dK)
            - 0.5j * (pump * (db * u + sd * b)))


def _tangent_increment(y, t, coeffs: RHSCoeffs, seeds: RHSCoeffs, dz: float):
    """The RK4 increment of ``ops/integrators._rk4_increment`` (the same
    operations, so the state follows ``integrate_reduce`` to the bit) and
    its derivative along ``(t, seeds)``, stage by stage."""
    half = dz * 0.5
    f = rhs_yaman_autonomous
    k1, d1 = f(0.0, y, coeffs), rhs_tangent(y, t, coeffs, seeds)
    y2, t2 = y + half * k1, t + half * d1
    k2, d2 = f(half, y2, coeffs), rhs_tangent(y2, t2, coeffs, seeds)
    y3, t3 = y + half * k2, t + half * d2
    k3, d3 = f(half, y3, coeffs), rhs_tangent(y3, t3, coeffs, seeds)
    y4, t4 = y + dz * k3, t + dz * d3
    k4, d4 = f(dz, y4, coeffs), rhs_tangent(y4, t4, coeffs, seeds)
    return ((dz / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4),
            (dz / 6.0) * (d1 + 2.0 * d2 + 2.0 * d3 + d4))


@spanned("psa.k1t.plain")
def solve_tangent_torch(coef, y0, t0, s, *, dz_m: float, n_steps: int):
    """Plain PyTorch version of :func:`solve_tangent_cuda`, on whatever
    device the tensors are: ``(y_end (8, B), t_end (8, B*D))``."""
    B, D, rdt = _check(coef, y0, t0, s, n_steps)
    y = torch.complex(y0[:4].T, y0[4:].T).repeat(D, 1)        # (B*D, 4), row d*B + b
    c = coef.T.repeat(D, 1)                                     # (B*D, 3)
    t = torch.complex(t0[:4].T, t0[4:].T)
    coeffs = RHSCoeffs(c[:, 0], c[:, 1], c[:, 2])
    seeds = RHSCoeffs(s[0], s[1], s[2])
    comp = torch.zeros_like(y) if rdt == torch.float32 else None
    for _ in range(int(n_steps)):
        delta, dt = _tangent_increment(y, t, coeffs, seeds, float(dz_m))
        if comp is None:
            y = y + delta
        else:
            corrected = delta - comp
            y_new = y + corrected
            comp = (y_new - y) - corrected
            y = y_new
        t = t + dt
    y_end = torch.cat([y[:B].real.T, y[:B].imag.T])
    return y_end.contiguous(), torch.cat([t.real.T, t.imag.T]).contiguous()


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    """The C launcher ``name`` of ``csrc/fwm4_tangent.cu``:
    ``fwm4_tangent_<type>`` takes the design by width; ``..._g1`` and
    ``..._g4`` run one design."""
    fn = getattr(_build.load_library("fwm4_tangent"), name)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(design: str, coef, y0, t0, s, dz_m, n_steps):
    """Check the planes, launch ``fwm4_tangent_<type><design>`` on the
    current stream and return its outputs; counts nothing."""
    B, D, rdt = _check(coef, y0, t0, s, n_steps)
    if coef.device.type != "cuda":
        raise ValueError(f"solve_tangent_cuda needs CUDA tensors, got a tensor on {coef.device}")
    for t in (coef, y0, t0, s):
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    name = f"fwm4_tangent_{_DTYPE_SUFFIX[rdt]}{design}"
    y_end = torch.empty((N_STATE, B), dtype=rdt, device=coef.device)
    t_end = torch.empty((N_STATE, B * D), dtype=rdt, device=coef.device)
    with torch.cuda.device(coef.device):   # the C side reads the current card
        err = _launcher(name)(coef.data_ptr(), y0.data_ptr(), t0.data_ptr(), s.data_ptr(),
                              y_end.data_ptr(), t_end.data_ptr(), B, D, int(n_steps),
                              float(dz_m),
                              torch.cuda.current_stream(coef.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return y_end, t_end


@spanned("psa.k1t.launch")
def solve_tangent_cuda(coef, y0, t0, s, *, dz_m: float, n_steps: int):
    """The state and the tangents of B lanes in D directions after
    ``n_steps`` rotating-frame RK4 steps, by the CUDA kernel: a (lane,
    direction) on a group of 4 threads below a width the kernel sets from
    the card's SM count, on one thread from there on (:func:`group_size`).
    The inputs are contiguous CUDA tensors of one real dtype (float64 or
    float32) in the layout of the module docstring.  Returns ``(y_end (8,
    B), t_end (8, B*D))`` without synchronizing."""
    out = _launch("", coef, y0, t0, s, dz_m, n_steps)
    _build.LAUNCHES[f"fwm4_tangent_{_DTYPE_SUFFIX[coef.dtype]}"] += 1
    return out


def solve_tangent_design(coef, y0, t0, s, *, dz_m: float, n_steps: int, group: int):
    """:func:`solve_tangent_cuda` through one design of the kernel: a (lane,
    direction) on ``group`` threads (1 or 4).  For holding the designs to
    each other and timing them; it counts no launch."""
    if group not in (1, 4):
        raise ValueError(f"group must be 1 or 4, got {group}")
    return _launch(f"_g{group}", coef, y0, t0, s, dz_m, n_steps)


def group_size(n: int) -> int:
    """The threads a (lane, direction) :func:`solve_tangent_cuda` gives
    ``n = B*D`` of them on the current card."""
    fn = _build.load_library("fwm4_tangent").fwm4_tangent_group
    fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_int
    return int(fn(int(n)))


def solve_tangent(coef, y0, t0, s, *, dz_m: float, n_steps: int):
    """:func:`solve_tangent_cuda` for CUDA tensors, :func:`solve_tangent_torch`
    for CPU tensors."""
    solve = solve_tangent_cuda if coef.device.type == "cuda" else solve_tangent_torch
    return solve(coef, y0, t0, s, dz_m=dz_m, n_steps=n_steps)


class _EndState(torch.autograd.Function):
    """``(coef (B, 3), y0 (B, 4) complex) -> y_end (B, 4) complex`` with
    the Jacobian of the directions asked for saved for the backward."""

    @staticmethod
    def forward(ctx, coef, y0, dz_m, n_steps):
        B, rdt = coef.shape[0], coef.dtype
        want_coef, want_state = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        # with no gradient asked for, one direction of zeros
        t0, s = directions(B, coef=want_coef, state=want_state, dtype=rdt,
                           device=coef.device)
        if t0.shape[1] == 0:
            t0, s = t0.new_zeros((N_STATE, B)), s.new_zeros((N_COEF, B))
        y_end, t_end = solve_tangent(
            coef.detach().T.contiguous(),
            torch.cat([y0.detach().real.T, y0.detach().imag.T]).contiguous(),
            t0, s, dz_m=dz_m, n_steps=n_steps)
        # (B, 8 outputs, D directions)
        ctx.save_for_backward(t_end.reshape(N_STATE, -1, B).permute(2, 0, 1))
        ctx.split = (N_COEF if want_coef else 0, N_STATE if want_state else 0)
        return torch.complex(y_end[:4].T, y_end[4:].T)

    @staticmethod
    def backward(ctx, grad):
        (jac,) = ctx.saved_tensors
        n_coef, n_state = ctx.split
        # torch's gradient of a complex tensor is dL/dRe + i dL/dIm
        g = torch.cat([grad.real, grad.imag], dim=-1).to(jac.dtype)      # (B, 8)
        gd = torch.einsum("br,brd->bd", g, jac)
        grad_coef = gd[:, :n_coef] if n_coef else None
        grad_y0 = (torch.complex(gd[:, n_coef:n_coef + 4], gd[:, n_coef + 4:])
                   if n_state else None)
        return grad_coef, grad_y0, None, None


def rk4_end_state(coef, y0, *, dz_m: float, n_steps: int):
    """The rotating-frame state after ``n_steps`` RK4 steps of ``dz_m``,
    differentiable in ``coef`` ``(B, 3)`` (gamma, alpha, delta_beta; real)
    and ``y0`` ``(B, 4)`` (complex of the matching type): one launch of the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if coef.ndim != 2 or coef.shape[1] != N_COEF or y0.shape != (coef.shape[0], 4):
        raise ValueError(f"need coef (B, 3) and y0 (B, 4), got {tuple(coef.shape)} and "
                         f"{tuple(y0.shape)}")
    return _EndState.apply(coef, y0, float(dz_m), int(n_steps))
