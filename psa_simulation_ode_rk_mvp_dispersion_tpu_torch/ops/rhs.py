"""Right-hand side of the scalar 4-wave FWM (Yaman-style) ODE system.

Counterpart of the JAX package's ``ops/rhs.py`` (reference
``yaman_model.py``): the state is a ``(..., 4)`` complex tensor in wave
order [pump1, pump2, signal, idler], and every term broadcasts over the
leading batch axes, so one function serves the single run and the batched
sweep.  Coefficients arrive pre-extracted in :class:`RHSCoeffs`.

Model (lab frame; reference ``yaman_model.py:21-27``):
    dA1/dz = -a/2 A1 + i g[(P1 + 2(P2+P3+P4))A1 + 2 A2* A3 A4 e^{+i db z}]
    dA2/dz = -a/2 A2 + i g[(P2 + 2(P1+P3+P4))A2 + 2 A1* A3 A4 e^{+i db z}]
    dA3/dz = -a/2 A3 + i g[(P3 + 2(P1+P2+P4))A3 + 2 A4* A1 A2 e^{-i db z}]
    dA4/dz = -a/2 A4 + i g[(P4 + 2(P1+P2+P3))A4 + 2 A3* A1 A2 e^{-i db z}]

The rotating (autonomous) frame substitutes ``A_{1,2} = B_{1,2} e^{+i db
z/2}``, ``A_{3,4} = B_{3,4}``: all powers are identical, the pumps gain a
``-i db/2 B`` term, and no ``db*z`` phase has to be represented.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.checks import as_f64, check_last_dim


@dataclasses.dataclass(frozen=True)
class RHSCoeffs:
    """Lowered per-instance physics coefficients consumed by the RHS.

    Fields are scalars or tensors of a common batch shape (broadcast against
    the state's leading axes), in per-meter units.
    """

    gamma: torch.Tensor       # Kerr coefficient [1/(W m)]
    alpha: torch.Tensor       # power attenuation [1/m]
    delta_beta: torch.Tensor  # phase mismatch [1/m]


def _expand(coef, batch_ndim: int, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar-or-(batch,) coefficient against (..., 4) state."""
    c = coef if isinstance(coef, torch.Tensor) else as_f64(coef, device=like.device)
    if c.ndim == 0:
        return c
    return c.reshape(c.shape + (1,) * (1 + batch_ndim - c.ndim))


def _imag_times(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(i * x) * a for real x and complex a, with ``i x`` built exactly as
    ``complex(0, x)``."""
    return torch.complex(torch.zeros_like(x), x).to(a.dtype) * a


def kerr_factors(a: torch.Tensor, self_coef: float = 1.0, cross_coef: float = 2.0) -> torch.Tensor:
    """SPM/XPM factors F_j = self*P_j + cross * sum_{k != j} P_k
    = cross*P_total + (self - cross)*P_j.

    Defaults (1, 2) are the co-polarized model of the reference
    (``yaman_model.py:135-156``); (2/3, 4/3) is the polarization-averaged
    variant, available through :func:`make_rhs_yaman`.
    """
    P = a.real * a.real + a.imag * a.imag
    total = P.sum(dim=-1, keepdim=True)
    return cross_coef * total + (self_coef - cross_coef) * P


def rhs_yaman(z, a: torch.Tensor, p: RHSCoeffs) -> torch.Tensor:
    """Lab-frame RHS with explicit exp(+-i dbeta z) phase factors (the
    reference discretization).  ``z`` is a scalar shared by the batch."""
    check_last_dim(a, 4, name="a")
    nb = a.ndim - 1
    rdt = a.real.dtype
    g = _expand(p.gamma, nb, a).to(rdt)
    al = _expand(p.alpha, nb, a)
    db = _expand(p.delta_beta, nb, a)

    F = kerr_factors(a)
    kerr = _imag_times(g, F * a)
    loss = (-0.5 * al.to(rdt)) * a

    theta = (db * z).to(rdt)
    ph = torch.complex(torch.cos(theta), torch.sin(theta)).to(a.dtype)  # e^{+i db z}
    phc = ph.conj()

    a1, a2, a3, a4 = a[..., 0:1], a[..., 1:2], a[..., 2:3], a[..., 3:4]
    s34 = a3 * a4
    s12 = a1 * a2
    fwm = _imag_times(2.0 * g, torch.cat(
        [
            ph * (a2.conj() * s34),
            ph * (a1.conj() * s34),
            phc * (a4.conj() * s12),
            phc * (a3.conj() * s12),
        ],
        dim=-1,
    ))
    return loss + kerr + fwm


def rhs_yaman_autonomous(z, b: torch.Tensor, p: RHSCoeffs) -> torch.Tensor:
    """Rotating-frame (autonomous) RHS: no explicit z dependence.

        dB1/dz = -a/2 B1 + i g[(F1 - db/(2g)) B1 + 2 B2* B3 B4]
        dB2/dz = -a/2 B2 + i g[(F2 - db/(2g)) B2 + 2 B1* B3 B4]
        dB3/dz = -a/2 B3 + i g[ F3 B3 + 2 B4* B1 B2]
        dB4/dz = -a/2 B4 + i g[ F4 B4 + 2 B3* B1 B2]

    Computed in real arithmetic, every product and sum in the order of the
    CUDA kernels' ``rhs`` (``csrc/fwm4_rk.cu``, ``csrc/fwm4_rk45.cu``), so
    that a kernel and this plain version round alike.
    """
    check_last_dim(b, 4, name="b")
    nb = b.ndim - 1
    rdt = b.real.dtype
    g = _expand(p.gamma, nb, b).to(rdt)
    neg_half_al = -0.5 * _expand(p.alpha, nb, b).to(rdt)
    neg_half_db = -0.5 * _expand(p.delta_beta, nb, b).to(rdt)
    two_g = 2.0 * g

    re, im = b.real, b.imag
    P = re * re + im * im
    tot = ((P[..., 0:1] + P[..., 1:2]) + P[..., 2:3]) + P[..., 3:4]
    gF = g * (2.0 * tot - P)
    d_re = neg_half_al * re - gF * im
    d_im = neg_half_al * im + gF * re

    r1, r2, r3, r4 = re[..., 0:1], re[..., 1:2], re[..., 2:3], re[..., 3:4]
    i1, i2, i3, i4 = im[..., 0:1], im[..., 1:2], im[..., 2:3], im[..., 3:4]
    s34_re, s34_im = r3 * r4 - i3 * i4, r3 * i4 + i3 * r4
    s12_re, s12_im = r1 * r2 - i1 * i2, r1 * i2 + i1 * r2
    # FWM drive, conj(B_k) * s for the partner k of each wave
    t_re = torch.cat([r2 * s34_re + i2 * s34_im, r1 * s34_re + i1 * s34_im,
                      r4 * s12_re + i4 * s12_im, r3 * s12_re + i3 * s12_im], dim=-1)
    t_im = torch.cat([r2 * s34_im - i2 * s34_re, r1 * s34_im - i1 * s34_re,
                      r4 * s12_im - i4 * s12_re, r3 * s12_im - i3 * s12_re], dim=-1)
    d_re = d_re - two_g * t_im
    d_im = d_im + two_g * t_re
    # pump-only detuning -i db/2 * B_{1,2} (x - 0 leaves the idler and signal exact)
    zero = torch.zeros_like(re[..., 2:4])
    d_re = d_re - torch.cat([neg_half_db * i1, neg_half_db * i2, zero], dim=-1)
    d_im = d_im + torch.cat([neg_half_db * r1, neg_half_db * r2, zero], dim=-1)
    return torch.complex(d_re, d_im)


def rotating_to_lab(z, b: torch.Tensor, p: RHSCoeffs) -> torch.Tensor:
    """Map rotating-frame state B back to lab-frame amplitudes A at z.

    ``z`` broadcasts against ``b``'s leading axes (scalar for one state,
    ``(S,)`` for a trajectory of shape ``(S, 4)``, ``(B,)`` or a scalar for a
    batch of shape ``(B, 4)``); the wave axis is appended here.
    """
    rdt = b.real.dtype
    theta = (0.5 * as_f64(p.delta_beta, device=b.device) * z).to(rdt)
    rot = torch.complex(torch.cos(theta), torch.sin(theta)).to(b.dtype)
    ones = torch.ones_like(rot)
    factors = torch.stack(torch.broadcast_tensors(rot, rot, ones, ones), dim=-1)
    return b * factors


# Reference-named alias (``yaman_model.py:10``): params here is RHSCoeffs.
rhs_yaman_simplified = rhs_yaman


def make_rhs_yaman(
    *,
    frame: str = "lab",
    kerr_self: float = 1.0,
    kerr_cross: float = 2.0,
):
    """Build a 4-wave RHS with custom Kerr SPM/XPM coefficients.

    ``(kerr_self, kerr_cross)``: (1, 2) is the co-polarized scalar model
    (the default everywhere); (2/3, 4/3) the polarization-averaged variant.
    Returns an ``f(z, a, p)`` usable with every integrator in this package.
    """
    if frame not in ("lab", "rotating"):
        raise ValueError("frame must be 'lab' or 'rotating'")
    base = rhs_yaman if frame == "lab" else rhs_yaman_autonomous
    if (kerr_self, kerr_cross) == (1.0, 2.0):
        return base

    def rhs(z, a, p):
        out = base(z, a, p)
        # replace the default Kerr term with the custom-coefficient one
        g = _expand(p.gamma, a.ndim - 1, a).to(a.real.dtype)
        F_default = kerr_factors(a)
        F_custom = kerr_factors(a, kerr_self, kerr_cross)
        return out + _imag_times(g, (F_custom - F_default) * a)

    return rhs
