"""Carry parameter objects of the JAX package over to this package.

:func:`from_reference` turns the JAX package's ``SimulationConfig``,
``RHSCoeffs``, ``DispersionParams``, ``SymmetricPlan``,
``PhaseMatchingConfig``, ``ModelParams`` (with its parts), ``NWaveCoeffs``,
``CombGrid``, ``TimeGrid``, ``GNLSECoeffs``, ``NLTerms``, ``LLECoeffs``,
``LLENormalization``, ``VGNLSECoeffs`` and ``SBSCoeffs`` into their counterparts here, reading every field by name through ``dataclasses.fields``
and every array leaf through ``np.asarray``.  It never imports JAX: it only
reads the objects it is given, so both packages can compute from
bit-identical float64 inputs.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np
import torch

from .config import SimulationConfig
from .models import fwm4, gnlse, lle, nwave, sbs, vgnlse
from .ops.dispersion import DispersionParams
from .ops.frequency_plan import SymmetricPlan
from .ops.phase_matching import PhaseMatchingConfig, PhaseMatchingMethod
from .ops.rhs import RHSCoeffs
from .utils.checks import resolve_device

# Counterparts by class name.  The classes in _TENSOR_CLASSES hold tensors;
# the others are host-side containers that keep numpy arrays and floats.
_CLASSES = {
    cls.__name__: cls
    for cls in (
        SimulationConfig, RHSCoeffs, DispersionParams, SymmetricPlan,
        PhaseMatchingConfig, fwm4.WavesParams, fwm4.FiberParams,
        fwm4.SimulationGrid, fwm4.PhaseMatchingParams, fwm4.CacheParams,
        fwm4.ModelParams, nwave.NWaveCoeffs, nwave.CombGrid, gnlse.TimeGrid,
        gnlse.GNLSECoeffs, gnlse.NLTerms, lle.LLECoeffs, lle.LLENormalization,
        vgnlse.VGNLSECoeffs, sbs.SBSCoeffs,
    )
}
_TENSOR_CLASSES = (RHSCoeffs, DispersionParams, SymmetricPlan, nwave.NWaveCoeffs,
                   gnlse.GNLSECoeffs, gnlse.NLTerms, lle.LLECoeffs, vgnlse.VGNLSECoeffs,
                   sbs.SBSCoeffs)
# Fields of a tensor class that stay Python floats (static metadata in JAX).
_STATIC_FIELDS = {("VGNLSECoeffs", "coherent")}
_ENUMS = {PhaseMatchingMethod.__name__: PhaseMatchingMethod}


def _leaf(v, *, as_tensor: bool, device, dtype):
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, tuple):
        return tuple(_leaf(x, as_tensor=as_tensor, device=device, dtype=dtype) for x in v)
    a = np.asarray(v)
    if as_tensor:
        return torch.as_tensor(np.array(a, dtype=np.float64), device=device).to(dtype)
    if isinstance(v, float):
        return v
    return np.array(a)


def from_reference(obj, *, device=None, dtype: torch.dtype = torch.float64):
    """The counterpart of a JAX-package parameter object.

    Array leaves of ``RHSCoeffs``, ``DispersionParams``, ``SymmetricPlan``,
    ``NWaveCoeffs``, ``GNLSECoeffs``, ``NLTerms``, ``LLECoeffs``,
    ``VGNLSECoeffs`` and ``SBSCoeffs`` (its ``fwm`` an ``RHSCoeffs``) become
    ``dtype`` tensors on ``device`` (``None``: the CUDA card;
    ``VGNLSECoeffs.coherent`` stays a float); host
    containers (``CombGrid``, ``TimeGrid`` and ``LLENormalization`` among
    them) keep numpy copies and floats.
    ``DispersionParams`` and ``SymmetricPlan`` are float64 by definition and
    ignore ``dtype``.
    """
    device = resolve_device(device)
    if isinstance(obj, Enum):
        return _ENUMS[type(obj).__name__](obj.value)
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        raise TypeError(f"cannot carry {type(obj)!r} across: not a parameter dataclass")
    name = type(obj).__name__
    if name not in _CLASSES:
        raise TypeError(f"no counterpart for {name} in this package")
    cls = _CLASSES[name]
    as_tensor = cls in _TENSOR_CLASSES
    kwargs = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, Enum) or (dataclasses.is_dataclass(v) and not isinstance(v, type)):
            kwargs[f.name] = from_reference(v, device=device, dtype=dtype)
        elif (name, f.name) in _STATIC_FIELDS:
            kwargs[f.name] = float(v)
        else:
            kwargs[f.name] = _leaf(v, as_tensor=as_tensor, device=device, dtype=dtype)
    return cls(**kwargs)
