"""Precision / dtype policy of the PyTorch port.

The JAX package carries three tiers because its TPU has no f64.  The H100
has native FP64, so the tiers map onto torch dtypes as follows:

- ``"x64"``  : float64 / complex128 -- reference parity.
- ``"df32"`` : float64 / complex128 -- the tier's <=1e-9 promise, met with
  native FP64 instead of two-float32 arithmetic (the two-float engines are
  not part of the port).
- ``"x32"``  : float32 / complex64 -- the fast tier.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

VALID_PRECISIONS = ("x64", "x32", "df32")


def validate_precision(precision: str) -> str:
    p = str(precision).strip().lower()
    if p not in VALID_PRECISIONS:
        raise ValueError(f"Unknown precision {precision!r}; use one of {VALID_PRECISIONS}")
    return p


def real_dtype(precision: str) -> torch.dtype:
    """Real scalar dtype of a precision tier."""
    if precision in ("x64", "df32"):
        return torch.float64
    if precision == "x32":
        return torch.float32
    raise ValueError(f"Unknown precision {precision!r}; use one of {VALID_PRECISIONS}")


def complex_dtype(precision: str) -> torch.dtype:
    """Complex dtype of a precision tier."""
    if precision in ("x64", "df32"):
        return torch.complex128
    if precision == "x32":
        return torch.complex64
    raise ValueError(f"Unknown precision {precision!r}; use one of {VALID_PRECISIONS}")


def dtypes_for(precision: str) -> Tuple[torch.dtype, torch.dtype]:
    """(real_dtype, complex_dtype) pair for a precision tier."""
    p = validate_precision(precision)
    return real_dtype(p), complex_dtype(p)


def require_non_df32(precision: str, *, family: str) -> str:
    """Validate a precision tier for a solver family that refuses ``df32``
    in the JAX package (it has no two-float engine there); the port
    refuses it alike, so that both packages take the same calls."""
    p = validate_precision(precision)
    if p == "df32":
        raise ValueError(
            f"precision='df32' is not implemented for the {family} solvers; use 'x64' "
            "(float64) or 'x32' (float32)")
    return p


def require_f64_leaves(what: str, **arrays) -> None:
    """Refuse coefficients already rounded to float32 in a ``df32`` solve,
    whose <=1e-9 promise needs float64 inputs (the JAX package's check of
    the same name, for its two-float split); build them with
    ``precision='df32'``."""
    for name, a in arrays.items():
        dt = a.dtype if isinstance(a, torch.Tensor) else np.asarray(a).dtype
        if dt not in (torch.float64, np.dtype(np.float64)):
            raise ValueError(
                f"{what}: df32 solves need float64 inputs, but {name} has dtype {dt} -- build "
                "it with precision='df32'")
