"""Model-agnostic fixed-step ODE integrators on torch tensors.

Counterpart of the JAX package's ``ops/integrators.py`` (reference
``integrators.py``): ``rk4_step``, ``integrate_fixed_grid``,
``integrate_reduce``, the Adams methods ``'ab4'``/``'abm4'`` and the eager
``integrate_fixed_step``/``integrate_interval`` wrappers.  A Python loop over
steps takes the place of ``lax.scan``, and the leading ``batch_ndim`` axes
of the state are independent instances (the JAX package ``vmap``s instead).

The contracts are the JAX package's:

- samples are taken at the initial state and at every step multiple of
  ``save_every``; the trailing ``n_steps % save_every`` steps are integrated
  but not saved, so they feed only ``ok``;
- failure is masked per instance: a lane whose new state is not finite
  freezes at its last finite state, clears ``ok`` and records the first bad
  step index in ``bad_step`` (``_steps_chunk``, JAX ``integrators.py:100-135``);
- the Adams methods run 3 RK4 startup steps that record ``f`` at each
  pre-step state (the RK4 ``k1``), then 1 (AB4) or 2 (ABM4, PECE) RHS
  evaluations per step (``_ms_bootstrap``, ``_ms_chunk``).

One thing differs from the JAX package: in single precision each step's
increment is added to the state with compensated (Kahan) summation.  Over
thousands of steps the rounding of ``y + increment`` is the dominant float32
error; at the bench configuration (2,500 steps, 10^3 lanes) compensation
takes the worst x32 ``P_max`` error against float64 from 5.9e-5 to 9.5e-7.
Double precision adds the increment plainly, as the JAX package does.  The
CUDA kernel does the same.

Everything is dtype-polymorphic: complex64 state for the x32 tier,
complex128 for x64/df32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

# f(z, y, params) -> dy/dz
RHSFunction = Callable[[Any, torch.Tensor, Any], torch.Tensor]

_VALID_METHODS = ("rk4", "ab4", "abm4")
_COMPENSATED = (torch.float32, torch.complex64)  # dtypes whose updates are compensated


def _rk4_increment(f: RHSFunction, z, y, dz, params):
    """The RK4 increment ``y_{n+1} - y_n`` and the stage ``k1 = f(y_n)``."""
    half = dz * 0.5
    k1 = f(z, y, params)
    k2 = f(z + half, y + half * k1, params)
    k3 = f(z + half, y + half * k2, params)
    k4 = f(z + dz, y + dz * k3, params)
    return (dz / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), k1


def rk4_step(f: RHSFunction, z, y, dz, params):
    """One classic 4th-order Runge-Kutta step (reference ``integrators.py:25-61``)."""
    return y + _rk4_increment(f, z, y, dz, params)[0]


def rk4ip_step(lin, N, y, h, Ny=None):
    """One 4th-order interaction-picture RK4 step (Hult 2007, J. Lightwave
    Technol. 25:3770), shared by the split-step families: the fixed-step
    chunk steppers and the step-doubling adaptive attempts.

    ``lin(a)`` applies the half-step linear propagator ``exp(L h/2)``;
    ``N(a)`` is the nonlinear operator.  ``Ny`` optionally supplies ``N(y)``,
    so that a step-doubling attempt shares the first stage between its
    coarse and fine steps.  The k4 term is added outside the last linear
    application, the defining subtlety of the scheme.
    """
    if Ny is None:
        Ny = N(y)
    a = lin(y)
    k1 = lin(h * Ny)
    k2 = h * N(a + 0.5 * k1)
    k3 = h * N(a + 0.5 * k2)
    k4 = h * N(lin(a + k3))
    return lin(a + (1.0 / 6.0) * (k1 + 2.0 * (k2 + k3))) + (1.0 / 6.0) * k4


class IntegrationState(NamedTuple):
    """State + masked failure tracking, each of the batch shape."""

    y: torch.Tensor
    ok: torch.Tensor        # bool: no NaN/Inf so far
    bad_step: torch.Tensor  # int32: first failing step index, or -1
    comp: Optional[torch.Tensor]  # rounding error of y (single precision), else None


def _lane_mask(mask: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (y.ndim - mask.ndim))


def _all_finite(y: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """Per-instance bool: every element of (possibly complex) y is finite."""
    fin = torch.isfinite(y)
    return fin.reshape(fin.shape[:batch_ndim] + (-1,)).all(dim=-1)


def _advance(st: IntegrationState, delta, step: int, check_nan: bool,
             batch_ndim: int) -> IntegrationState:
    """Add the increment ``delta`` (compensated in single precision) where
    the lane stays finite; freeze the lane otherwise."""
    if st.comp is None:
        y_new, comp = st.y + delta, None
    else:
        corrected = delta - st.comp
        y_new = st.y + corrected
        comp = (y_new - st.y) - corrected
    if not check_nan:
        return IntegrationState(y_new, st.ok, st.bad_step, comp)
    fin = _all_finite(y_new, batch_ndim)
    ok_new = st.ok & fin
    keep = _lane_mask(ok_new, y_new)
    bad = torch.where(st.ok & ~fin, step, st.bad_step)
    if comp is not None:
        comp = torch.where(keep, comp, st.comp)
    return IntegrationState(torch.where(keep, y_new, st.y), ok_new, bad, comp)


def _initial_state(y0: torch.Tensor, batch_ndim: int) -> IntegrationState:
    shape = y0.shape[:batch_ndim]
    return IntegrationState(
        y=y0,
        ok=torch.ones(shape, dtype=torch.bool, device=y0.device),
        bad_step=torch.full(shape, -1, dtype=torch.int32, device=y0.device),
        comp=torch.zeros_like(y0) if y0.dtype in _COMPENSATED else None,
    )


def _march(f: RHSFunction, y0, params, *, z0: float, dz: float, n_steps: int,
           check_nan: bool, method: str, batch_ndim: int
           ) -> Iterator[Tuple[int, IntegrationState]]:
    """Yield ``(i, state after step i)`` for i = 0 .. n_steps-1.

    z at step i is ``z0 + i*dz`` (no accumulated summation drift)."""
    st = _initial_state(y0, batch_ndim)
    kw = dict(check_nan=check_nan, batch_ndim=batch_ndim)
    if method == "rk4":
        for i in range(n_steps):
            st = _advance(st, _rk4_increment(f, z0 + i * dz, st.y, dz, params)[0], i, **kw)
            yield i, st
        return

    # Adams: RK4 startup steps recording f(y_n) = k1 (no extra evaluations)
    n_boot = min(3, n_steps)
    fs = []
    for b in range(n_boot):
        delta, k1 = _rk4_increment(f, z0 + b * dz, st.y, dz, params)
        st = _advance(st, delta, b, **kw)
        fs.append(k1)
        yield b, st
    if n_steps <= 3:
        return
    correct = method == "abm4"
    c = dz / 24.0
    f1, f2, f3 = fs[2], fs[1], fs[0]
    for i in range(n_boot, n_steps):
        z = z0 + i * dz
        f0 = f(z, st.y, params)
        delta = c * (55.0 * f0 - 59.0 * f1 + 37.0 * f2 - 9.0 * f3)
        if correct:
            fp = f(z + dz, st.y + delta, params)
            delta = c * (9.0 * fp + 19.0 * f0 - 5.0 * f1 + f2)
        st = _advance(st, delta, i, **kw)
        f1, f2, f3 = f0, f1, f2
        yield i, st


def _check_args(save_every: int, n_steps: int, method: str) -> str:
    if save_every <= 0:
        raise ValueError("save_every must be a positive integer")
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    method = method.lower()
    if method not in _VALID_METHODS:
        raise ValueError(f"method must be one of {_VALID_METHODS}, got {method!r}")
    return method


# ---------------------------------------------------------------------------
# Fixed-step integration with decimated trajectory storage
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntegrationResult:
    """Trajectory solve output: row 0 of the saved axis is the initial
    condition, then one row per ``save_every`` steps (reference
    ``integrators.py:111-142``)."""

    z_saved: torch.Tensor   # (S+1,)
    y_saved: torch.Tensor   # (*batch, S+1, *state_shape)
    y_final: torch.Tensor   # state after all n_steps
    ok: torch.Tensor        # bool, batch shape
    bad_step: torch.Tensor  # int32, -1 if ok


def integrate_fixed_grid(
    f: RHSFunction,
    y0: torch.Tensor,
    params,
    *,
    z0: float,
    dz: float,
    n_steps: int,
    save_every: int = 1,
    check_nan: bool = True,
    unroll: int = 4,
    method: str = "rk4",
    batch_ndim: int = 0,
) -> IntegrationResult:
    """Integrate ``n_steps`` fixed steps from ``z0`` with step ``dz``,
    saving every ``save_every``-th state.  ``method``: ``'rk4'``, ``'ab4'``
    or ``'abm4'``, all under the same save-grid / NaN-freeze contract.
    ``unroll`` is accepted for API parity and has no effect."""
    method = _check_args(save_every, n_steps, method)
    z0, dz = float(z0), float(dz)
    rows = [y0]
    st = _initial_state(y0, batch_ndim)
    for i, st in _march(f, y0, params, z0=z0, dz=dz, n_steps=n_steps,
                        check_nan=check_nan, method=method, batch_ndim=batch_ndim):
        if (i + 1) % save_every == 0:
            rows.append(st.y)
    S = n_steps // save_every
    steps = torch.arange(S + 1, dtype=torch.int64, device=y0.device) * save_every
    z_saved = z0 + steps.to(y0.real.dtype) * dz
    return IntegrationResult(
        z_saved=z_saved, y_saved=torch.stack(rows, dim=batch_ndim),
        y_final=st.y, ok=st.ok, bad_step=st.bad_step,
    )


# ---------------------------------------------------------------------------
# Reduction-mode integration (no trajectory materialization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReduceResult:
    reduction: Any
    y_final: torch.Tensor
    ok: torch.Tensor
    bad_step: torch.Tensor


def integrate_reduce(
    f: RHSFunction,
    y0: torch.Tensor,
    params,
    *,
    z0: float,
    dz: float,
    n_steps: int,
    save_every: int = 1,
    reduce_init: Any = None,
    reduce_fn: Optional[Callable[[Any, torch.Tensor], Any]] = None,
    check_nan: bool = True,
    unroll: int = 4,
    method: str = "rk4",
    batch_ndim: int = 0,
) -> ReduceResult:
    """Like :func:`integrate_fixed_grid`, but folds each saved sample (the
    initial state and every ``save_every``-th state) into
    ``reduce_fn(acc, y)`` instead of stacking the trajectory: O(B * state)
    memory for a batch of B instances.  ``unroll`` has no effect."""
    if reduce_fn is None:
        raise ValueError("reduce_fn is required")
    method = _check_args(save_every, n_steps, method)
    acc = reduce_fn(reduce_init, y0)
    st = _initial_state(y0, batch_ndim)
    for i, st in _march(f, y0, params, z0=float(z0), dz=float(dz), n_steps=n_steps,
                        check_nan=check_nan, method=method, batch_ndim=batch_ndim):
        if (i + 1) % save_every == 0:
            acc = reduce_fn(acc, st.y)
    return ReduceResult(reduction=acc, y_final=st.y, ok=st.ok, bad_step=st.bad_step)


# ---------------------------------------------------------------------------
# Eager convenience wrappers (reference API parity)
# ---------------------------------------------------------------------------

def integrate_fixed_step(
    f: RHSFunction,
    z_grid,
    y0,
    params,
    *,
    save_every: int = 1,
    check_nan: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-parity API over an explicit uniform z-grid
    (``integrators.py:68-142``): returns host ``(z_out, y_out)`` and raises
    ``FloatingPointError`` on NaN/Inf when ``check_nan``."""
    zg = np.asarray(z_grid, dtype=float)
    if zg.ndim != 1:
        raise ValueError("z_grid must be a one-dimensional array")
    if save_every <= 0:
        raise ValueError("save_every must be a positive integer")
    n_steps = zg.size - 1
    if n_steps < 1:
        raise ValueError("z_grid must contain at least 2 points")
    dz = float(zg[-1] - zg[0]) / n_steps
    if not np.allclose(np.diff(zg), dz, rtol=1e-9, atol=0.0):
        raise ValueError("z_grid must be uniform for the fixed-step integrator")

    res = integrate_fixed_grid(
        f, torch.as_tensor(y0), params, z0=float(zg[0]), dz=dz, n_steps=n_steps,
        save_every=save_every, check_nan=check_nan,
    )
    if check_nan and not bool(res.ok):
        bad = int(res.bad_step)
        raise FloatingPointError(
            f"NaN or Inf detected at step {bad}, z = {zg[0] + bad * dz}"
        )
    return res.z_saved.cpu().numpy(), res.y_saved.cpu().numpy()


def integrate_interval(
    f: RHSFunction,
    z_max: float,
    dz: float,
    y0,
    params,
    *,
    save_every: int = 1,
    check_nan: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Integrate on [0, z_max] with fixed dz (reference
    ``integrators.py:150-204``): n_steps = round(z_max/dz)."""
    if z_max <= 0.0:
        raise ValueError("z_max must be positive")
    if dz <= 0.0:
        raise ValueError("dz must be positive")
    n_steps = int(round(float(z_max) / float(dz)))
    z_grid = np.linspace(0.0, float(z_max), n_steps + 1)
    return integrate_fixed_step(
        f, z_grid, y0, params, save_every=save_every, check_nan=check_nan
    )
