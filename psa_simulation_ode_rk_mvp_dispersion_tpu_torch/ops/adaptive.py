"""Embedded adaptive Runge-Kutta (Dormand-Prince 5(4)) integration on torch
tensors.

Counterpart of the JAX package's ``ops/adaptive.py``: the tableau and the
controller constants, :func:`rk45_step`, :func:`_error_norm`,
:func:`_advance_segment`, :func:`integrate_adaptive_grid`,
:func:`integrate_adaptive_reduce` and :func:`run_adaptive_trajectory`.  The
leading ``batch_ndim`` axes of the state are independent lanes, each with its
own step size, counters and ``ok`` flag (the JAX package ``vmap``s a masked
``lax.while_loop`` instead).

The contract is the JAX package's:

- output lands exactly on the user's grid: an outer loop over the grid's
  segments, an adaptive loop inside each;
- the step proposal ``dt`` carries from one segment to the next; a step is
  clamped to the segment's end;
- error norm: RMS over the state's components of ``|err| / (atol + rtol *
  max(|y|, |y_new|))``, 0/0 (a dark wave with ``atol=0``) read as 0;
- step factor ``0.9 * err^(-1/5)`` clipped to [0.2, 5]; a non-finite step
  counts as a rejection with factor 0.5;
- a lane fails (``ok`` cleared, state frozen at its last accepted value)
  when a step at ``dt <= dt_min`` is rejected, or when it used
  ``max_steps`` attempts in one segment without reaching its end;
- ``z_final`` adds a trailing unsaved span that feeds ``ok`` and the
  counters only.

Three choices are the port's own, and the CUDA kernel (``csrc/fwm4_rk45.cu``)
makes the same ones, so that it and this plain version take the same steps:

- an attempt's first stage is the last accepted step's seventh (FSAL: six
  RHS evaluations per attempt, where the JAX package makes seven); it
  carries across segments, so the lab frame's comes from ``z_start +
  length`` of the segment before;
- each segment is integrated in local ``z`` in ``[0, length]`` (as the
  JAX kernel ``ops/pallas_adaptive.py`` does; the JAX scan carries global
  ``z``), with ``dt_min = 1e-12 * (length + 1)``; a non-autonomous RHS is
  called at ``z_start + z_local``;
- the first step is ``dt0 = 0.1 * (z_1 - z_0)`` (the JAX scan's rule; the
  JAX kernel starts from ``dz``), where ``z_1`` is the end of the first span,
  saved or trailing.

The loop's condition, "any lane still active", reads one boolean from the
device each iteration.  This is the plain version: on the card it serves
the lab frame and the comparisons; the rotating-frame sweeps run the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .integrators import _all_finite

RHSFunction = Callable[[Any, torch.Tensor, Any], torch.Tensor]

# Dormand-Prince 5(4) Butcher tableau (RK45 / MATLAB ode45 / SciPy RK45).
_C = (0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0)
_A = (
    (),
    (1.0 / 5.0,),
    (3.0 / 40.0, 9.0 / 40.0),
    (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
    (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
    (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0, -5103.0 / 18656.0),
    (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0),
)
# 5th-order solution weights == last A row + 0 (FSAL property).
_B5 = _A[6] + (0.0,)
# 4th-order embedded weights.
_B4 = (
    5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
    -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0,
)

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 5.0
ORDER_EXP = -1.0 / 5.0
DT_MIN_FACTOR = 1e-12


def _dp45(f: RHSFunction, z, y, k1, dz, params):
    """One Dormand-Prince step from ``y`` whose first stage ``k1 = f(z, y)``
    is given: ``(y5, err, k7)``.  ``k7 = f(z + dz, y5)`` is the first stage
    of the step after an accepted one (FSAL), so an attempt evaluates the
    RHS six times.

    ``z`` and ``dz`` are scalars or per-lane tensors that broadcast against
    ``y``.  Stage sums run in the tableau's order, ``yi = y + (dz*a_ij)*k_j``
    (the seventh stage's input is ``y5``, since ``b5`` is the last row of
    ``A``), and ``err`` accumulates in the order of the stages."""
    ks = [k1]
    for i in range(1, 7):
        yi = y
        for j, aij in enumerate(_A[i]):
            if aij != 0.0:
                yi = yi + (dz * aij) * ks[j]
        ks.append(f(z + _C[i] * dz, yi, params))
    err = torch.zeros_like(y)
    for i in range(7):
        d = _B5[i] - _B4[i]
        if d != 0.0:
            err = err + (dz * d) * ks[i]
    return yi, err, ks[6]


def rk45_step(f: RHSFunction, z, y, dz, params) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Dormand-Prince step: ``(y5, error_estimate)`` (see :func:`_dp45`)."""
    y5, err, _k7 = _dp45(f, z, y, f(z, y, params), dz, params)
    return y5, err


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag if x.is_complex() else x * x


def _error_norm(err, y, y_new, *, atol: float, rtol: float, batch_ndim: int = 0):
    """Weighted RMS of the error estimate per lane (complex-aware).

    ``|x|`` is ``sqrt(re^2 + im^2)`` and the mean of the squares is summed
    component by component in index order, as the CUDA kernel does."""
    scale = atol + rtol * torch.sqrt(torch.maximum(_abs2(y), _abs2(y_new)))
    e = torch.sqrt(_abs2(err))
    # identically-zero components (dark waves) with atol=0 give scale=0 AND
    # err=0: treat 0/0 as 0 instead of poisoning the norm with NaN
    pos = scale > 0
    r = torch.where(pos, e / torch.where(pos, scale, torch.ones_like(scale)),
                    torch.zeros_like(e))
    q = (r * r).reshape(r.shape[:batch_ndim] + (-1,))
    total = q[..., 0]
    for k in range(1, q.shape[-1]):
        total = total + q[..., k]
    # the mean as a true division, as the kernels divide: on the card torch
    # computes a division by a Python number as a product with its rounded
    # reciprocal, a last-bit difference unless the count is a power of two
    return torch.sqrt(total / torch.full_like(total, float(q.shape[-1])))


class _SegCarry(NamedTuple):
    """Per-lane controller state, each field of the batch shape (``y`` of
    the state's shape)."""

    y: torch.Tensor
    k1: torch.Tensor          # f(z, y): the next attempt's first stage
    dt: torch.Tensor
    ok: torch.Tensor          # bool: lane healthy
    n_accepted: torch.Tensor  # int32
    n_rejected: torch.Tensor  # int32


def _advance_segment(f: RHSFunction, carry: _SegCarry, z_start: float, length: float, params, *,
                     rtol: float, atol: float, max_steps: int,
                     batch_ndim: int = 0) -> _SegCarry:
    """Adaptively advance every lane over ``[z_start, z_start + length]``
    in local ``z``.  Finished and failed lanes are frozen by per-lane masks;
    a lane that used ``max_steps`` attempts without reaching the end fails."""
    y, k1 = carry.y, carry.k1
    rdt = y.real.dtype
    lane_shape = y.shape[:batch_ndim]
    col = lane_shape + (1,) * (y.ndim - batch_ndim)   # per-lane value against y
    seg = torch.tensor(float(length), dtype=rdt, device=y.device)
    dt_min = torch.tensor(DT_MIN_FACTOR * (float(length) + 1.0), dtype=rdt, device=y.device)
    z = torch.zeros(lane_shape, dtype=rdt, device=y.device)
    dt, ok, n_acc, n_rej = carry.dt, carry.ok, carry.n_accepted, carry.n_rejected
    active = ok & (z < seg)
    it = 0
    while it < max_steps and bool(active.any()):
        h = torch.minimum(dt, seg - z)
        hc = h.reshape(col)
        y_new, err, k7 = _dp45(f, float(z_start) + z.reshape(col), y, k1, hc, params)
        enorm = _error_norm(err, y, y_new, atol=atol, rtol=rtol, batch_ndim=batch_ndim)
        finite = torch.isfinite(enorm) & _all_finite(y_new, batch_ndim)
        accept = active & finite & (enorm <= 1.0)
        factor = torch.where(
            finite,
            torch.clamp(SAFETY * torch.pow(torch.clamp_min(enorm, 1e-16), ORDER_EXP),
                        MIN_FACTOR, MAX_FACTOR),
            torch.full_like(enorm, 0.5),
        )
        reject = active & ~accept
        ok = ok & ~(reject & (h <= dt_min))      # dt underflow with rejection
        dt = torch.where(active, torch.maximum(dt * factor, dt_min), dt)
        z = torch.where(accept, z + h, z)
        y = torch.where(accept.reshape(col), y_new, y)
        k1 = torch.where(accept.reshape(col), k7, k1)
        n_acc = n_acc + accept.to(torch.int32)
        n_rej = n_rej + reject.to(torch.int32)
        it += 1
        active = ok & (z < seg)
    return _SegCarry(y, k1, dt, ok & (z >= seg), n_acc, n_rej)


def _initial_carry(f: RHSFunction, z0: float, y0: torch.Tensor, params, dt0: float,
                   batch_ndim: int) -> _SegCarry:
    lane_shape = y0.shape[:batch_ndim]
    dev = y0.device
    return _SegCarry(
        y=y0,
        k1=f(z0, y0, params),
        dt=torch.full(lane_shape, float(dt0), dtype=y0.real.dtype, device=dev),
        ok=torch.ones(lane_shape, dtype=torch.bool, device=dev),
        n_accepted=torch.zeros(lane_shape, dtype=torch.int32, device=dev),
        n_rejected=torch.zeros(lane_shape, dtype=torch.int32, device=dev),
    )


def integrate_spans(f: RHSFunction, y0: torch.Tensor, params, spans: Sequence[Tuple[float, float]],
                    *, tail: Optional[Tuple[float, float]] = None, rtol: float, atol: float,
                    max_steps: int, dt0: Optional[float] = None, batch_ndim: int = 0,
                    on_saved: Optional[Callable[[torch.Tensor], None]] = None) -> _SegCarry:
    """The core of the adaptive integrators: advance over each saved span
    ``(z_start, length)`` in turn, handing the state at each span's end to
    ``on_saved``, then over the unsaved ``tail`` span, which feeds ``ok`` and
    the counters only.  The returned carry's ``y`` is the state at the end
    of the last saved span.  The first stage of each attempt carries over
    from the last accepted step, across spans too."""
    z0, first = spans[0] if spans else (tail if tail is not None else (0.0, 0.0))
    c = _initial_carry(f, float(z0), y0, params,
                       0.1 * float(first) if dt0 is None else float(dt0), batch_ndim)
    kw = dict(rtol=float(rtol), atol=float(atol), max_steps=int(max_steps), batch_ndim=batch_ndim)
    for z_start, length in spans:
        c = _advance_segment(f, c, z_start, length, params, **kw)
        if on_saved is not None:
            on_saved(c.y)
    if tail is not None:
        t = _advance_segment(f, c, tail[0], tail[1], params, **kw)
        c = c._replace(ok=t.ok, n_accepted=t.n_accepted, n_rejected=t.n_rejected)
    return c


def _grid_spans(z_grid, z_final):
    zg = np.asarray(z_grid.cpu() if isinstance(z_grid, torch.Tensor) else z_grid, dtype=np.float64)
    if zg.ndim != 1 or zg.shape[0] < 1:
        raise ValueError("z_grid must be 1-D with at least 1 point")
    spans = [(float(a), float(b - a)) for a, b in zip(zg[:-1], zg[1:])]
    tail = None if z_final is None else (float(zg[-1]), float(z_final) - float(zg[-1]))
    return zg, spans, tail


@dataclasses.dataclass(frozen=True)
class AdaptiveResult:
    z_saved: torch.Tensor     # (S,) the requested output grid
    y_saved: torch.Tensor     # (*batch, S, *state)
    y_final: torch.Tensor
    ok: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor


def integrate_adaptive_grid(
    f: RHSFunction,
    y0: torch.Tensor,
    params,
    *,
    z_grid,
    rtol: float = 1e-9,
    atol: float = 1e-12,
    dt0=None,
    max_steps_per_segment: int = 10_000,
    z_final=None,
    batch_ndim: int = 0,
) -> AdaptiveResult:
    """Dormand-Prince 5(4) integration with output on ``z_grid``.

    ``z_grid`` is an increasing 1-D grid (row 0 = initial z).  Each segment
    ``[z_i, z_{i+1}]`` is integrated adaptively and its end state saved.
    ``z_final`` (optional, > ``z_grid[-1]``) adds the trailing unsaved span
    ``[z_grid[-1], z_final]``: it folds into ``ok``/``n_accepted``/
    ``n_rejected`` only, while ``y_final`` and the saved rows stay at the last
    grid point."""
    zg, spans, tail = _grid_spans(z_grid, z_final)
    rows = [y0]
    c = integrate_spans(f, y0, params, spans, tail=tail, rtol=rtol, atol=atol,
                        max_steps=max_steps_per_segment, dt0=dt0, batch_ndim=batch_ndim,
                        on_saved=rows.append)
    return AdaptiveResult(
        z_saved=torch.as_tensor(zg, dtype=y0.real.dtype, device=y0.device),
        y_saved=torch.stack(rows, dim=batch_ndim),
        y_final=c.y, ok=c.ok, n_accepted=c.n_accepted, n_rejected=c.n_rejected,
    )


@dataclasses.dataclass(frozen=True)
class AdaptiveReduceResult:
    reduction: Any
    y_final: torch.Tensor
    ok: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor


def integrate_adaptive_reduce(
    f: RHSFunction,
    y0: torch.Tensor,
    params,
    *,
    z_grid,
    reduce_init,
    reduce_fn,
    rtol: float = 1e-9,
    atol: float = 1e-12,
    dt0=None,
    max_steps_per_segment: int = 10_000,
    z_final=None,
    batch_ndim: int = 0,
) -> AdaptiveReduceResult:
    """Like :func:`integrate_adaptive_grid`, but folds each grid-point state
    after the initial one into ``reduce_fn(acc, y)`` instead of keeping the
    trajectory; seed ``reduce_init`` with the z=0 contribution."""
    _zg, spans, tail = _grid_spans(z_grid, z_final)
    acc = [reduce_init]

    def fold(y):
        acc[0] = reduce_fn(acc[0], y)

    c = integrate_spans(f, y0, params, spans, tail=tail, rtol=rtol, atol=atol,
                        max_steps=max_steps_per_segment, dt0=dt0, batch_ndim=batch_ndim,
                        on_saved=fold)
    return AdaptiveReduceResult(reduction=acc[0], y_final=c.y, ok=c.ok,
                                n_accepted=c.n_accepted, n_rejected=c.n_rejected)


# ---------------------------------------------------------------------------
# Runner glue: rk45 trajectory with the fixed-step output contract
# ---------------------------------------------------------------------------

def run_adaptive_trajectory(cfg, model_params, coeffs, A0, *, frame: str, length_unit: str,
                            return_length_unit, z0_m: float = 0.0, device=None):
    """Back end of ``run_single_simulation`` for ``cfg.integrator == 'rk45'``.

    States on the decimated grid ``z_k = z0 + k * save_every * dz`` (row 0 the
    initial state), z in ``return_length_unit``; the trailing ``n_steps %
    save_every`` span is integrated but unsaved.  ``device``: where the solve
    runs (``None``: the CUDA card)."""
    from ..utils.checks import resolve_device
    from ..utils.precision import complex_dtype, validate_precision
    from ..utils.units import length_scale_to_m
    from .rhs import rhs_yaman, rhs_yaman_autonomous, rotating_to_lab

    precision = validate_precision(cfg.precision)
    device = resolve_device(device)
    dz_m = model_params.grid.dz_m
    n_steps = int(round(model_params.fiber.length_m / dz_m))
    save_every = int(cfg.save_every)
    n_chunks = n_steps // save_every
    out_scale = length_scale_to_m(length_unit if return_length_unit is None else return_length_unit)
    if n_chunks == 0:
        # saved grid is just row 0 (the ICs); nothing observable to integrate
        return np.asarray([z0_m]) / out_scale, np.asarray(A0, dtype=np.complex128)[None, :]
    z_grid = z0_m + np.arange(n_chunks + 1, dtype=np.float64) * (save_every * dz_m)
    res = integrate_adaptive_grid(
        rhs_yaman if frame == "lab" else rhs_yaman_autonomous,
        torch.as_tensor(np.asarray(A0), dtype=complex_dtype(precision), device=device),
        coeffs, z_grid=z_grid, rtol=float(cfg.rtol), atol=float(cfg.atol),
        max_steps_per_segment=int(cfg.max_steps),
        z_final=z0_m + n_steps * dz_m if n_steps % save_every else None,
    )
    if cfg.check_nan and not bool(res.ok):
        raise FloatingPointError(
            "NaN/Inf or step-size underflow during adaptive (rk45) integration")
    y_saved = res.y_saved
    if frame == "rotating":
        y_saved = rotating_to_lab(res.z_saved, y_saved, coeffs)
    return z_grid / out_scale, y_saved.to(torch.complex128).cpu().numpy()
