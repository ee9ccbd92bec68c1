"""Shared experiment defaults (phase-matching config, parity helper).

Counterpart of the JAX package's ``experiments/_shared.py``.  The
parity-critical dispersion default lives with the physics it encodes:
:func:`~..ops.phase_matching.dispersion_at_pump_center` (the expansion point
the SYMMETRIC_EVEN formula assumes).
"""

from __future__ import annotations

from ..ops.phase_matching import (
    PhaseMatchingConfig,
    PhaseMatchingMethod,
    dispersion_at_pump_center as _dispersion_at_pump_center,
)

_PM_DEFAULT = PhaseMatchingConfig(
    method=PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4,
    atol=0.0, rtol=1e-12,
)
