"""Taylor dispersion model beta(omega) and phase-mismatch evaluation.

Counterpart of the JAX package's ``ops/dispersion.py`` (reference
``dispersion.py``): D/S/dS-dlambda unit conversions, beta2/beta3/beta4
builders from D and S, ``DispersionParams``, ``beta_taylor``,
``delta_beta_from_omegas``, ``delta_beta_symmetric`` and
``dispersion_params_from_D_S``.  The Taylor coefficients live in one dense
float64 tensor indexed by order, so ``beta_taylor`` is a Horner evaluation
that broadcasts over any ``omega`` batch shape.

Known reference defect NOT replicated by default: ``dispersion.py:455``
passes dS/dlambda in the ``D`` slot of ``beta4_from_D_S``.  The intended
formula is implemented:
    beta4 = -(lambda^4 / (2 pi c)^3) * (6 D + 6 lambda S + lambda^2 dS/dlambda)
and ``compat_reference_beta4_bug=True`` reproduces the defect for
cross-validation against the reference.

Units: omega [rad/s]; beta_n [s^n/m]; D [s/m^2]; S [s/m^3]; dS/dlambda [s/m^4].
"""

from __future__ import annotations

import dataclasses
from math import factorial
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..constants import c, TWO_PI
from ..utils.checks import (
    as_f64,
    check_last_dim,
    check_positive,
    to_scalar_float,
    validate_positive,
)
from ..utils.units import (  # noqa: F401  (re-exported for parity)
    D_ps_nm_km_to_SI,
    S_ps_nm2_km_to_SI,
    dSdlmbd_ps_nm3_km_to_SI,
)
from .frequency_plan import enforce_energy_conservation

DEFAULT_MAX_ORDER = 4


# ---------------------------------------------------------------------------
# beta_n from engineering dispersion parameters (reference dispersion.py:102-139)
# ---------------------------------------------------------------------------

def beta2_from_D(lambda_ref_m: float, D_SI: float) -> float:
    """beta2 [s^2/m] = -(lambda^2 / (2 pi c)) * D."""
    lam = validate_positive(lambda_ref_m, name="lambda_ref_m")
    D = to_scalar_float(D_SI, name="D_SI")
    return -((lam * lam) / (TWO_PI * c)) * D


def beta3_from_D_S(lambda_ref_m: float, D_SI: float, S_SI: float) -> float:
    """beta3 [s^3/m] = (lambda^4 / (4 pi^2 c^2)) * (S + 2 D / lambda)."""
    lam = validate_positive(lambda_ref_m, name="lambda_ref_m")
    D = to_scalar_float(D_SI, name="D_SI")
    S = to_scalar_float(S_SI, name="S_SI")
    pref = lam**4 / (TWO_PI**2 * c**2)
    return pref * (S + 2.0 * D / lam)


def beta4_from_D_S(
    lambda_ref_m: float, D_SI: float, S_SI: float, dSdlmbd_SI: float
) -> float:
    """beta4 [s^4/m] = -(lambda^4 / (2 pi c)^3) * (6 D + 6 lambda S + lambda^2 dS/dlambda)."""
    lam = validate_positive(lambda_ref_m, name="lambda_ref_m")
    D = to_scalar_float(D_SI, name="D_SI")
    S = to_scalar_float(S_SI, name="S_SI")
    dSdlam = to_scalar_float(dSdlmbd_SI, name="dSdlmbd_SI")
    pref = -(lam**4) / (TWO_PI * c) ** 3
    return pref * (6.0 * D + 6.0 * lam * S + lam**2 * dSdlam)


# ---------------------------------------------------------------------------
# DispersionParams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DispersionParams:
    """Taylor expansion of beta(omega) around ``omega_ref``:

        beta(omega) = sum_n coeffs[n] * (omega - omega_ref)^n / n!

    ``coeffs[n]`` is beta_n in [s^n/m]; both fields are float64 tensors.
    """

    omega_ref: torch.Tensor     # () [rad/s]
    coeffs: torch.Tensor        # (K,) beta_n by order n

    def __post_init__(self):
        object.__setattr__(self, "omega_ref", as_f64(self.omega_ref))
        object.__setattr__(self, "coeffs", as_f64(self.coeffs))
        wref = self.omega_ref
        if not (bool(torch.isfinite(wref).all()) and bool((wref > 0.0).all())):
            raise ValueError("omega_ref must be finite and > 0")
        if self.coeffs.ndim != 1:
            raise ValueError(
                f"coeffs must be 1-D (order-indexed), got shape {tuple(self.coeffs.shape)}")
        if not bool(torch.isfinite(self.coeffs).all()):
            raise ValueError("coeffs must be finite")

    def to(self, device) -> "DispersionParams":
        return DispersionParams(self.omega_ref.to(device), self.coeffs.to(device))

    # -- construction -------------------------------------------------------

    @classmethod
    def from_betas(
        cls,
        omega_ref: float,
        *,
        beta0: float = 0.0,
        beta1: float = 0.0,
        beta2: float = 0.0,
        beta3: float = 0.0,
        beta4: float = 0.0,
        extra: Optional[Dict[int, float]] = None,
    ) -> "DispersionParams":
        """Named-field constructor (reference ``dispersion.py:142-194``).
        ``extra`` maps order -> beta_n and overrides the named fields for
        overlapping orders."""
        named = [beta0, beta1, beta2, beta3, beta4]
        max_n = 4
        clean: Dict[int, float] = {}
        if extra is not None:
            if not isinstance(extra, dict):
                raise TypeError("extra must be a dict {order:int -> beta_order:float} or None")
            for k, v in extra.items():
                if not isinstance(k, int):
                    raise TypeError(f"extra key must be int order, got {type(k)!r}")
                if k < 0:
                    raise ValueError(f"extra order must be >= 0, got {k}")
                clean[k] = to_scalar_float(v, name=f"extra[{k}]")
            if clean:
                max_n = max(max_n, max(clean))
        coeffs = np.zeros(max_n + 1, dtype=np.float64)
        for n, v in enumerate(named):
            coeffs[n] = to_scalar_float(v, name=f"beta{n}")
        for n, v in clean.items():
            coeffs[n] = v
        wref = validate_positive(omega_ref, name="omega_ref")
        return cls(omega_ref=wref, coeffs=coeffs)

    # -- named accessors (parity: dispersion.py:196-230) --------------------

    def get_beta_n(self, n: int) -> torch.Tensor:
        if not isinstance(n, int):
            raise TypeError("n must be int")
        if n < 0:
            raise ValueError("n must be >= 0")
        if n >= self.num_orders:
            return torch.zeros((), dtype=torch.float64, device=self.coeffs.device)
        return self.coeffs[n]

    @property
    def num_orders(self) -> int:
        return int(self.coeffs.shape[0])

    @property
    def beta0(self):
        return self.get_beta_n(0)

    @property
    def beta1(self):
        return self.get_beta_n(1)

    @property
    def beta2(self):
        return self.get_beta_n(2)

    @property
    def beta3(self):
        return self.get_beta_n(3)

    @property
    def beta4(self):
        return self.get_beta_n(4)

    def available_orders(self) -> Tuple[int, ...]:
        """Orders with nonzero coefficients."""
        return tuple(int(n) for n in torch.nonzero(self.coeffs).flatten().tolist())

    def scaled(self, length_scale_to_m: float) -> "DispersionParams":
        """Convert per-length_unit coefficients to per-meter (divide by the
        scale).  Parity: reference ``simulation.py:126-150``."""
        s = float(length_scale_to_m)
        if s == 1.0:
            return self
        return DispersionParams(omega_ref=self.omega_ref, coeffs=self.coeffs / s)


# ---------------------------------------------------------------------------
# beta(omega) evaluation
# ---------------------------------------------------------------------------

def beta_taylor(
    omega,
    disp: DispersionParams,
    *,
    max_order: int = DEFAULT_MAX_ORDER,
):
    """beta(omega) [1/m] via the Taylor series around ``disp.omega_ref``, up
    to ``max_order`` inclusive, as a Horner evaluation with factorial-scaled
    coefficients.  Parity: reference ``dispersion.py:233-279``."""
    if not isinstance(max_order, int):
        raise TypeError("max_order must be int")
    if max_order < 0:
        raise ValueError("max_order must be >= 0")
    check_positive(omega, name="omega")

    dw = as_f64(omega) - disp.omega_ref
    k = min(max_order, disp.num_orders - 1)
    cf = disp.coeffs
    # Horner: (((c_k/k!)*dw + c_{k-1}/(k-1)!)*dw + ...)*dw + c_0
    out = cf[k] / float(factorial(k))
    for n in range(k - 1, -1, -1):
        out = out * dw + cf[n] / float(factorial(n))
    return out


def delta_beta_from_omegas(
    omegas,
    disp: DispersionParams,
    *,
    max_order: int = DEFAULT_MAX_ORDER,
    atol: float = 0.0,
    rtol: float = 1e-12,
):
    """dbeta = beta(omega3) + beta(omega4) - beta(omega1) - beta(omega2) for
    ``omegas`` of shape ``(..., 4)``.  Parity: reference
    ``dispersion.py:282-318``."""
    om = as_f64(omegas)
    check_last_dim(om, 4, name="omegas")
    check_positive(om, name="omegas")
    enforce_energy_conservation(om, atol=atol, rtol=rtol)

    b = beta_taylor(om, disp, max_order=max_order)
    return (b[..., 2] + b[..., 3]) - (b[..., 0] + b[..., 1])


def delta_beta_symmetric(
    omega_c,
    omega_d,
    Omega,
    disp: DispersionParams,
    *,
    even_orders: Iterable[int] = (2, 4),
):
    """Even-order closed form for symmetric plans:

        dbeta = sum_{n even >= 2} beta_n(omega_c) * (Omega^n - omega_d^n) * 2/n!

    Parity: reference ``dispersion.py:321-372``."""
    check_positive(omega_c, name="omega_c")
    evens = list(even_orders)
    if len(evens) == 0:
        raise ValueError("even_orders must contain at least one order (e.g., 2,4)")
    for n in evens:
        if not isinstance(n, int):
            raise TypeError("even_orders must contain ints")
        if n < 2:
            raise ValueError(f"even order must be >=2, got {n}")
        if n % 2 != 0:
            raise ValueError(f"Order must be even, got {n}")

    od = as_f64(omega_d)
    Om = as_f64(Omega)
    cf = disp.coeffs

    out = torch.zeros(torch.broadcast_shapes(od.shape, Om.shape),
                      dtype=torch.float64, device=cf.device)
    for n in evens:
        if n >= disp.num_orders:
            continue
        out = out + cf[n] * (Om**n - od**n) * (2.0 / float(factorial(n)))
    return out


# ---------------------------------------------------------------------------
# Convenience builder (reference dispersion.py:375-466)
# ---------------------------------------------------------------------------

def dispersion_params_from_D_S(
    lambda_ref_m: float,
    D: float,
    S: Optional[float] = None,
    dSdlmbd: Optional[float] = None,
    *,
    D_units: str = "SI",
    S_units: str = "SI",
    dSdlmbd_units: str = "SI",
    omega_ref: Optional[float] = None,
    beta0: float = 0.0,
    beta1: float = 0.0,
    extra: Optional[Dict[int, float]] = None,
    compat_reference_beta4_bug: bool = False,
) -> DispersionParams:
    """Build ``DispersionParams`` at ``lambda_ref_m`` from D (and optionally
    S, dS/dlambda).  ``compat_reference_beta4_bug=True`` reproduces the
    reference defect at ``dispersion.py:455``."""
    lam = validate_positive(lambda_ref_m, name="lambda_ref_m")
    if omega_ref is None:
        wref = TWO_PI * c / lam
    else:
        wref = validate_positive(omega_ref, name="omega_ref")

    if D_units == "SI":
        D_SI = to_scalar_float(D, name="D")
    elif D_units == "ps/nm/km":
        D_SI = D_ps_nm_km_to_SI(D)
    else:
        raise ValueError(f"Unknown D_units={D_units!r}. Use 'SI' or 'ps/nm/km'.")

    if S is not None:
        if S_units == "SI":
            S_SI = to_scalar_float(S, name="S")
        elif S_units == "ps/nm^2/km":
            S_SI = S_ps_nm2_km_to_SI(S)
        else:
            raise ValueError(f"Unknown S_units={S_units!r}. Use 'SI' or 'ps/nm^2/km'.")
    else:
        S_SI = 0.0

    if dSdlmbd is not None:
        if dSdlmbd_units == "SI":
            dSdlmbd_SI = to_scalar_float(dSdlmbd, name="dSdlmbd")
        elif dSdlmbd_units == "ps/nm^3/km":
            dSdlmbd_SI = dSdlmbd_ps_nm3_km_to_SI(dSdlmbd)
        else:
            raise ValueError(f"Unknown dSdlmbd_units={dSdlmbd_units!r}")
    else:
        dSdlmbd_SI = 0.0

    b2 = beta2_from_D(lam, D_SI)
    b3 = beta3_from_D_S(lam, D_SI, S_SI)
    if compat_reference_beta4_bug:
        b4 = beta4_from_D_S(lam, dSdlmbd_SI, S_SI, dSdlmbd_SI)
    else:
        b4 = beta4_from_D_S(lam, D_SI, S_SI, dSdlmbd_SI)

    return DispersionParams.from_betas(
        wref, beta0=beta0, beta1=beta1, beta2=b2, beta3=b3, beta4=b4, extra=extra
    )
