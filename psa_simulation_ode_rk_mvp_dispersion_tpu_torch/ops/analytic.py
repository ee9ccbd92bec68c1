"""Closed-form small-signal (undepleted-pump) parametric gain.

Counterpart of the JAX package's ``ops/analytic.py``, on float64 tensors.
The classical dual-pump FWM results (Agrawal ch. 10; the convention of
``ops/rhs.py``): with constant pumps P1, P2 (lossless, undepleted) and weak
signal/idler,

    g^2 = C^2 - (kappa/2)^2,     C = 2 gamma sqrt(P1 P2),
    kappa = dbeta + gamma (P1 + P2)        (total nonlinear phase mismatch)

    PIA (idler unseeded):  G_s(z) = 1 + (C/g)^2 sinh^2(g z)
    (for kappa^2 > 4C^2, g is imaginary and sinh -> sin: oscillatory regime)

    PSA at kappa = 0 with |A4(0)| = |A3(0)|: gain extrema over the input
    signal phase are e^{+-2 C z} (G_max * G_min = 1).

These are independent analytic oracles for the numerical solvers.
"""

from __future__ import annotations

import torch

from ..utils.checks import as_f64


def parametric_g(gamma, P1, P2, delta_beta):
    """``(C, kappa, g^2)`` of the undepleted-pump linearization; ``g^2 < 0``
    is the oscillatory regime (use :func:`pia_signal_gain`)."""
    gamma = as_f64(gamma)
    C = 2.0 * gamma * torch.sqrt(as_f64(P1) * as_f64(P2))
    kappa = as_f64(delta_beta) + gamma * (as_f64(P1) + as_f64(P2))
    return C, kappa, C**2 - (kappa / 2.0) ** 2


def pia_signal_gain(z, gamma, P1, P2, delta_beta):
    """Phase-insensitive (idler-unseeded) signal power gain G_s(z), exact in
    the undepleted-pump limit.  Broadcasts over any argument."""
    C, kappa, g2 = parametric_g(gamma, P1, P2, delta_beta)
    z = as_f64(z)
    g = torch.sqrt(g2.abs() + 1e-300)
    grow = (C / g) ** 2 * torch.sinh(g * z) ** 2
    osc = (C / g) ** 2 * torch.sin(g * z) ** 2
    # exactly phase-matched edge (g2 == 0): limit C^2 z^2
    lim = C**2 * z**2
    out = torch.where(g2 > 0, grow, torch.where(g2 < 0, osc, lim))
    return 1.0 + out


def psa_gain_extrema(z, gamma, P1, P2):
    """PSA gain extrema over input signal phase at kappa = 0 with an
    equal-magnitude idler seed: (G_max, G_min) = (e^{2Cz}, e^{-2Cz})."""
    C = 2.0 * as_f64(gamma) * torch.sqrt(as_f64(P1) * as_f64(P2))
    r = 2.0 * C * as_f64(z)
    return torch.exp(r), torch.exp(-r)
