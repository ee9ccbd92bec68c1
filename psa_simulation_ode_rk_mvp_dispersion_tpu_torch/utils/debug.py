"""Opt-in runtime checks on a solve (the sanitizer analog; SURVEY.md
section 5).

Counterpart of the JAX package's ``utils/debug.py``, which threads
``jax.experimental.checkify`` checks through ``jit``/``scan``.  The contract
is the same here: a check that fails inside a run is recorded, not raised
mid-integration, and surfaces on the host as an error object.

    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils.debug import (
        checked_rhs, run_checked)

    rhs_dbg = checked_rhs(rhs_yaman, name="rhs_yaman")   # asserts finiteness
    err, out = run_checked(lambda y0: integrate_fixed_grid(
        rhs_dbg, y0, coeffs, z0=0., dz=dz, n_steps=n), y0)
    err.throw()   # raises with the failing check's message, if any

Inside :func:`run_checked` each wrapped RHS folds the finiteness of its
output into a flag on the output's device, so the checks add no host
synchronization to the run; the flags are read once, when the run returns.
"""

from __future__ import annotations

import contextvars
from typing import Callable, Dict, Optional

import torch

# name -> device bool flag (True while every output was finite) of the
# innermost run_checked in progress; None outside of one
_RECORD: "contextvars.ContextVar[Optional[Dict[str, torch.Tensor]]]" = contextvars.ContextVar(
    "psa_torch_checks", default=None)


class CheckError:
    """The outcome of :func:`run_checked`: the first failed check's message,
    or none.  ``throw()`` raises ``FloatingPointError`` with it."""

    def __init__(self, message: Optional[str] = None):
        self._message = message

    def get(self) -> Optional[str]:
        """The failed check's message, or None when every check passed."""
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatingPointError(self._message)

    def __repr__(self) -> str:
        return f"CheckError({self._message!r})"


def _all_finite(out) -> torch.Tensor:
    t = out if isinstance(out, torch.Tensor) else torch.as_tensor(out)
    if t.is_complex():
        t = torch.view_as_real(t)
    return torch.isfinite(t).all()


def checked_rhs(rhs: Callable, *, name: str = "rhs") -> Callable:
    """Wrap an ``f(z, y, params)`` RHS with finiteness checks on its output.

    Under :func:`run_checked` a non-finite derivative is recorded and the
    run goes on; outside of one the wrapper raises ``FloatingPointError`` at
    the first non-finite derivative (one host read per call)."""
    message = f"{name}: non-finite derivative produced"

    def wrapped(z, y, params):
        out = rhs(z, y, params)
        fin = _all_finite(out)
        record = _RECORD.get()
        if record is None:
            if not bool(fin):
                raise FloatingPointError(message)
        else:
            record[message] = fin if message not in record else record[message] & fin
        return out

    return wrapped


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif hasattr(out, "__dataclass_fields__"):
        for k in out.__dataclass_fields__:
            yield from _leaves(getattr(out, k))


def run_checked(fn: Callable, *args, **kwargs):
    """Run ``fn`` with the checks of :func:`checked_rhs` recording, and
    return ``(error, result)``; call ``error.throw()`` to raise on failure.

    As checkify's float checks do, a non-finite floating-point tensor in the
    result (tensors, and those inside tuples, lists, dicts and dataclasses)
    also fails.  The first failure in the order of the checks wins."""
    record: Dict[str, torch.Tensor] = {}
    token = _RECORD.set(record)
    try:
        out = fn(*args, **kwargs)
    finally:
        _RECORD.reset(token)
    for message, fin in record.items():
        if not bool(fin):
            return CheckError(message), out
    for t in _leaves(out):
        if (t.is_floating_point() or t.is_complex()) and not bool(_all_finite(t)):
            return CheckError("non-finite value in the result (nan or inf)"), out
    return CheckError(), out
