"""Frequency-plan utilities for four-wave mixing, on float64 tensors.

Counterpart of the JAX package's ``ops/frequency_plan.py`` (reference
``frequency_plan.py``): lambda/f/omega conversions, ``SymmetricPlan``,
energy conservation, ``infer_symmetry_from_omegas``, the ``plan_from_*``
builders and ``describe_plan``.  Every function broadcasts over batch
shapes, so a whole spectrum's plans are one ``(B, 4)`` tensor.  Inputs that
are not tensors become float64 tensors on the default device; tensors keep
their device.

Wave order across the project:
    [pump1, pump2, signal, idler] -> [omega1, omega2, omega3, omega4]

Symmetric parametrization:
    omega_c = (omega1 + omega2)/2,  omega_d = (omega1 - omega2)/2,
    Omega   = omega3 - omega_c
    omega1 = omega_c + omega_d, omega2 = omega_c - omega_d,
    omega3 = omega_c + Omega,   omega4 = omega_c - Omega

Energy conservation: omega1 + omega2 = omega3 + omega4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..constants import c, TWO_PI
from ..utils.checks import as_f64, check_finite, check_last_dim, check_positive

WAVE_ORDER: Tuple[str, str, str, str] = ("pump1", "pump2", "signal", "idler")


# ---------------------------------------------------------------------------
# Scalar/array conversions (broadcast over any shape)
# ---------------------------------------------------------------------------

def _two_pi_c_over(x) -> torch.Tensor:
    """2*pi*c / x, correctly rounded.  (``float / tensor`` in torch computes
    ``reciprocal(x) * float``, which can differ by one ulp.)"""
    x = as_f64(x)
    return torch.full_like(x, TWO_PI * c) / x


def omega_from_f(f_hz):
    """f [Hz] -> omega [rad/s]."""
    check_positive(f_hz, name="f_hz")
    return TWO_PI * as_f64(f_hz)


def f_from_omega(omega):
    """omega [rad/s] -> f [Hz]."""
    check_positive(omega, name="omega")
    return as_f64(omega) / TWO_PI


def omega_from_lambda(lambda_m):
    """Vacuum wavelength [m] -> omega [rad/s]: omega = 2*pi*c/lambda."""
    check_positive(lambda_m, name="lambda_m")
    return _two_pi_c_over(lambda_m)


def lambda_from_omega(omega):
    """omega [rad/s] -> vacuum wavelength [m]: lambda = 2*pi*c/omega."""
    check_positive(omega, name="omega")
    return _two_pi_c_over(omega)


# ---------------------------------------------------------------------------
# Energy conservation
# ---------------------------------------------------------------------------

def energy_conservation_residual(omega):
    """(omega1 + omega2) - (omega3 + omega4) over the trailing wave axis."""
    om = as_f64(omega)
    check_last_dim(om, 4, name="omega")
    return (om[..., 0] + om[..., 1]) - (om[..., 2] + om[..., 3])


def enforce_energy_conservation(omega, *, atol: float = 0.0, rtol: float = 1e-12) -> None:
    """Raise ``ValueError`` unless omega1+omega2 == omega3+omega4 within
    tolerance (reference ``frequency_plan.py:112-131``)."""
    check_last_dim(omega, 4, name="omega")
    a = as_f64(omega)
    lhs = a[..., 0] + a[..., 1]
    rhs = a[..., 2] + a[..., 3]
    bad = ~torch.isclose(lhs, rhs, atol=atol, rtol=rtol)
    if bool(bad.any()):
        i = tuple(torch.nonzero(torch.atleast_1d(bad))[0].tolist())
        lhs_b = float(torch.atleast_1d(lhs)[i])
        rhs_b = float(torch.atleast_1d(rhs)[i])
        raise ValueError(
            "Energy conservation violated: omega1+omega2 != omega3+omega4. "
            f"(lhs={lhs_b:.16e}, rhs={rhs_b:.16e}, diff={(lhs_b - rhs_b):.16e})"
        )


# ---------------------------------------------------------------------------
# Symmetric plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SymmetricPlan:
    """Symmetric frequency-plan parameters as float64 tensors of a common
    batch shape.  Parity: reference ``frequency_plan.py:134-199``."""

    omega_c: torch.Tensor  # (omega1 + omega2)/2  [rad/s]
    omega_d: torch.Tensor  # (omega1 - omega2)/2  [rad/s]
    Omega: torch.Tensor    # omega3 - omega_c     [rad/s]

    def __post_init__(self):
        for name in ("omega_c", "omega_d", "Omega"):
            object.__setattr__(self, name, as_f64(getattr(self, name)))
        oc, od = self.omega_c, self.omega_d
        if not (bool(torch.isfinite(oc).all()) and bool((oc > 0.0).all())):
            raise ValueError("omega_c must be finite and > 0 (rad/s)")
        check_finite(od, name="omega_d")
        check_finite(self.Omega, name="Omega")
        if bool((od.abs() >= oc).any()):
            raise ValueError(
                "Invalid symmetric plan: |omega_d| must be < omega_c to keep "
                "omega1, omega2 positive."
            )

    @property
    def omega1(self):
        return self.omega_c + self.omega_d

    @property
    def omega2(self):
        return self.omega_c - self.omega_d

    @property
    def omega3(self):
        return self.omega_c + self.Omega

    @property
    def omega4(self):
        return self.omega_c - self.Omega

    def omegas(self) -> torch.Tensor:
        """Stack to project wave order ``(..., 4)``; validates positivity
        (reference ``frequency_plan.py:184-199``)."""
        om = torch.stack(
            torch.broadcast_tensors(self.omega1, self.omega2, self.omega3, self.omega4),
            dim=-1,
        )
        if bool((om <= 0.0).any()):
            raise ValueError(
                "This symmetric plan produces non-positive omega for "
                "signal/idler. Adjust Omega and/or omega_c."
            )
        enforce_energy_conservation(om)
        return om


def plan_from_symmetry(omega_c, omega_d, Omega) -> torch.Tensor:
    """Build ``(..., 4)`` omegas from symmetric parameters."""
    return SymmetricPlan(omega_c=omega_c, omega_d=omega_d, Omega=Omega).omegas()


def infer_symmetry_from_omegas(
    omega1,
    omega2,
    omega3,
    omega4=None,
    *,
    atol: float = 0.0,
    rtol: float = 1e-12,
) -> SymmetricPlan:
    """Infer (omega_c, omega_d, Omega) from omega1..3 (+ optional omega4
    check).  Parity: reference ``frequency_plan.py:215-255``."""
    w1, w2, w3 = as_f64(omega1), as_f64(omega2), as_f64(omega3)
    check_positive(w1, name="omega1")
    check_positive(w2, name="omega2")
    check_positive(w3, name="omega3")

    omega_c = 0.5 * (w1 + w2)
    omega_d = 0.5 * (w1 - w2)
    Omega = w3 - omega_c
    sp = SymmetricPlan(omega_c=omega_c, omega_d=omega_d, Omega=Omega)

    if omega4 is None:
        check_positive(w1 + w2 - w3, name="omega4(inferred)")
    else:
        w4 = as_f64(omega4)
        check_positive(w4, name="omega4")
        om = torch.stack(torch.broadcast_tensors(w1, w2, w3, w4), dim=-1)
        enforce_energy_conservation(om, atol=atol, rtol=rtol)
        if not torch.allclose(sp.omega4, w4, atol=atol, rtol=max(rtol, 1e-12)):
            raise ValueError("Inferred symmetric parameters are inconsistent with omega4.")
    return sp


def plan_from_omegas(
    omega1,
    omega2,
    omega3,
    omega4=None,
    *,
    atol: float = 0.0,
    rtol: float = 1e-12,
) -> torch.Tensor:
    """Build ``(..., 4)`` omegas; omega4 inferred from energy conservation
    when omitted.  Parity: reference ``frequency_plan.py:258-288``."""
    w1, w2, w3 = as_f64(omega1), as_f64(omega2), as_f64(omega3)
    check_positive(w1, name="omega1")
    check_positive(w2, name="omega2")
    check_positive(w3, name="omega3")

    if omega4 is None:
        w4 = w1 + w2 - w3
        check_positive(w4, name="omega4(inferred)")
    else:
        w4 = as_f64(omega4)
        check_positive(w4, name="omega4")

    om = torch.stack(torch.broadcast_tensors(w1, w2, w3, w4), dim=-1)
    enforce_energy_conservation(om, atol=atol, rtol=rtol)
    return om


def plan_from_wavelengths(
    lambda1_m,
    lambda2_m,
    lambda3_m,
    lambda4_m=None,
    *,
    atol: float = 0.0,
    rtol: float = 1e-12,
) -> torch.Tensor:
    """Build ``(..., 4)`` omegas from vacuum wavelengths [m]; conversion
    first, then the missing wave is inferred in omega (reference
    ``frequency_plan.py:291-327``).  ``lambda3_m`` may be a batch."""
    w1 = omega_from_lambda(lambda1_m)
    w2 = omega_from_lambda(lambda2_m)
    w3 = omega_from_lambda(lambda3_m)
    w4 = None if lambda4_m is None else omega_from_lambda(lambda4_m)
    return plan_from_omegas(w1, w2, w3, w4, atol=atol, rtol=rtol)


def describe_plan(omega) -> str:
    """Human-readable multi-line description of a single (4,) plan.
    Parity: reference ``frequency_plan.py:330-350``."""
    om = as_f64(omega).cpu().numpy()
    if om.shape != (4,):
        raise ValueError(f"omega must have shape (4,), got {om.shape}")
    check_positive(om, name="omega")
    lam = TWO_PI * c / om
    f = om / TWO_PI

    lines = ["Frequency plan (wave order: pump1, pump2, signal, idler):"]
    for i, label in enumerate(WAVE_ORDER):
        lines.append(
            f"  {label:6s}: "
            f"omega={om[i]: .16e} rad/s, "
            f"f={f[i]: .16e} Hz, "
            f"lambda={lam[i]: .16e} m"
        )
    lines.append(
        f"  Check: omega1+omega2 - (omega3+omega4) = {(om[0] + om[1]) - (om[2] + om[3]): .16e} rad/s"
    )
    return "\n".join(lines)
