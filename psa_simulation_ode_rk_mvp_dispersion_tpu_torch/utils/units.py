"""Unit-system boundary helpers.

All internal computation is in SI meters (matching the reference runner's
convention, ``simulation.py:13-16``).  Unit conversion happens once at the API
boundary:

- length units 'm' / 'km'  (``simulation.py:58-67``)
- dispersion D, S, dS/dlambda engineering units (``dispersion.py:72-99``)
- attenuation dB/km -> 1/m (pattern used at ``main.py:73``)
- gain linear <-> dB
"""

from __future__ import annotations

import numpy as np

from ..constants import c, TWO_PI
from .checks import to_scalar_float, validate_positive

LN10 = float(np.log(10.0))


def length_scale_to_m(length_unit: str) -> float:
    """Scale factor converting lengths in ``length_unit`` to meters.

    Mirrors reference ``simulation.py:58-67`` ('m' | 'km').
    """
    u = str(length_unit).strip().lower()
    if u == "m":
        return 1.0
    if u == "km":
        return 1000.0
    raise ValueError(f"Unsupported length_unit={length_unit!r}. Use 'm' or 'km'.")


def wavelength_scale(unit: str) -> float:
    """Scale factor from meters to the requested wavelength display unit."""
    u = str(unit).strip().lower()
    if u == "m":
        return 1.0
    if u == "nm":
        return 1e9
    raise ValueError(f"Unsupported wavelength unit {unit!r}. Use 'm' or 'nm'.")


# --- dispersion engineering-unit conversions (reference dispersion.py:72-99) ---

def D_ps_nm_km_to_SI(D_ps_nm_km: float) -> float:
    """ps/(nm*km) -> s/m^2.  1 ps/(nm km) = 1e-12 s / (1e-9 m * 1e3 m) = 1e-6 s/m^2."""
    return to_scalar_float(D_ps_nm_km, name="D_ps_nm_km") * 1e-6


def S_ps_nm2_km_to_SI(S_ps_nm2_km: float) -> float:
    """ps/(nm^2*km) -> s/m^3.  1 ps/(nm^2 km) = 1e-12 / (1e-18 * 1e3) = 1e3 s/m^3."""
    return to_scalar_float(S_ps_nm2_km, name="S_ps_nm2_km") * 1e3


def dSdlmbd_ps_nm3_km_to_SI(dSdlmbd_ps_nm3_km: float) -> float:
    """ps/(nm^3*km) -> s/m^4.  1 ps/(nm^3 km) = 1e-12 / (1e-27 * 1e3) = 1e12 s/m^4."""
    return to_scalar_float(dSdlmbd_ps_nm3_km, name="dSdlmbd_ps_nm3_km") * 1e12


def alpha_db_per_km_to_1_m(alpha_db_per_km: float) -> float:
    """Power attenuation dB/km -> 1/m (pattern at reference ``main.py:73``)."""
    a = to_scalar_float(alpha_db_per_km, name="alpha_db_per_km")
    return (LN10 / 10.0) * a / 1000.0


def db_from_linear(g_linear):
    """10*log10(G)."""
    return 10.0 * np.log10(g_linear)


def linear_from_db(g_db):
    return 10.0 ** (np.asarray(g_db) / 10.0)


def omega_from_lambda_scalar(lambda_m: float) -> float:
    """Host-side scalar lambda->omega used during parameter construction."""
    lam = validate_positive(lambda_m, name="lambda_m")
    return TWO_PI * c / lam
