"""Validation helpers and tensor conversion at the API boundary.

PyTorch runs eagerly, so every value check runs on every call (the JAX
package skips value checks on tracers).  A check on a CUDA tensor reads one
boolean back from the device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, and for
    ``None`` the CUDA card.  Without a card, ``None`` raises instead of
    falling back to the CPU; the CPU is used only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was given: the port runs on "
            "the CUDA card by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def device_key(device) -> str:
    """The name of one device, for a cache keyed by device: a CUDA device
    with its index (a bare ``cuda`` is the current card), so that ``cuda``
    and ``cuda:0`` share an entry and no entry names whichever card is
    current."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def as_f64(x: Any, device=None) -> torch.Tensor:
    """A float64 tensor of ``x``.  A tensor keeps its device; anything else
    (Python or numpy scalars and arrays) lands on ``device``, where ``None``
    means the host: parameter objects (plans, dispersion, scalars) are built
    there, as the JAX package builds them with numpy, and the entry points
    pass their resolved device for every value that feeds a solve."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device="cpu" if device is None else device)


def to_scalar_float(x: Any, *, name: str) -> float:
    """Coerce a real scalar to float, mirroring reference semantics
    (``dispersion.py:50-57``)."""
    try:
        v = float(x)
    except Exception as e:  # noqa: BLE001 - mirror reference behaviour
        raise TypeError(f"{name} must be a real scalar, got {type(x)!r}") from e
    if not np.isfinite(v):
        raise ValueError(f"{name} must be finite, got {v!r}")
    return v


def validate_positive(x: Any, *, name: str) -> float:
    v = to_scalar_float(x, name=name)
    if v <= 0.0:
        raise ValueError(f"{name} must be > 0, got {v!r}")
    return v


def validate_nonneg(x: Any, *, name: str) -> float:
    v = to_scalar_float(x, name=name)
    if v < 0.0:
        raise ValueError(f"{name} must be >= 0, got {v!r}")
    return v


def check_finite(arr: Any, *, name: str) -> None:
    if not bool(torch.isfinite(as_f64(arr)).all()):
        raise ValueError(f"{name} must contain only finite values")


def check_positive(arr: Any, *, name: str) -> None:
    a = as_f64(arr)
    if not bool(torch.isfinite(a).all()):
        raise ValueError(f"{name} must contain only finite values")
    if bool((a <= 0.0).any()):
        raise ValueError(f"{name} must contain only positive values")


def check_nonneg(arr: Any, *, name: str) -> None:
    a = as_f64(arr)
    if not bool(torch.isfinite(a).all()):
        raise ValueError(f"{name} must contain only finite values")
    if bool((a < 0.0).any()):
        raise ValueError(f"{name} must contain only non-negative values")


def check_last_dim(arr: Any, n: int, *, name: str) -> None:
    """Generalizes the reference's hard ``shape == (4,)`` checks
    (``frequency_plan.py:101-109``) to batched ``(..., n)`` arrays."""
    shape = tuple(arr.shape) if hasattr(arr, "shape") else np.shape(arr)
    if len(shape) < 1 or shape[-1] != n:
        raise ValueError(f"{name} must have trailing dimension {n}, got shape {shape}")
