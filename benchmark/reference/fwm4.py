"""Plain NumPy reference of the 4-wave (Yaman) model: the phase mismatch from
D and S, fixed-step RK4 and adaptive Dormand-Prince 5(4), and the gain in
dB over the saved maxima.

Written from the model's equations, independent of the port.  The state is
integrated in the rotating frame, ``A_{1,2} = B_{1,2} e^{+i db z/2}``,
``A_{3,4} = B_{3,4}``, the change of variables that the port documents for
its sweeps: the powers, and so the gain, are those of the lab frame, and
RK4 on the rotating frame is the discretization the port promises (RK4 on
the lab frame's ``e^{i db z}`` factors is another one, whose truncation
error would swamp a comparison at rounding level).

    dB1/dz = -a/2 B1 + i g [F1 B1 + 2 B2* B3 B4] - i db/2 B1
    dB2/dz = -a/2 B2 + i g [F2 B2 + 2 B1* B3 B4] - i db/2 B2
    dB3/dz = -a/2 B3 + i g [F3 B3 + 2 B4* B1 B2]
    dB4/dz = -a/2 B4 + i g [F4 B4 + 2 B3* B1 B2]

with ``F_j = 2 sum_k P_k - P_j``.  Every function takes a ``dtype``
(float64 for the reference, float32 for the control that the tests run).
"""

from __future__ import annotations

import numpy as np

C0 = 299_792_458.0
TWO_PI = 2.0 * np.pi


def _complex(dtype):
    return np.complex128 if np.dtype(dtype) == np.float64 else np.complex64


def delta_beta(lam_p1_m: float, lam_p2_m: float, lam_s_m, D_ps_nm_km: float,
               S_ps_nm2_km: float):
    """``(dbeta [1/m], valid)`` of the symmetric even-order phase matching,
    orders 2 and 4, with beta_2 and beta_4 from D and S at the pumps' centre
    frequency (dS/dlambda = 0):

        dbeta = b2 (Om^2 - wd^2) + b4 (Om^4 - wd^4) / 12,

    ``wc = (w1 + w2)/2``, ``wd = (w1 - w2)/2``, ``Om = w3 - wc``,
    ``b2 = -lc^2 D / (2 pi c)``, ``b4 = -lc^4 (6 D + 6 lc S) / (2 pi c)^3``,
    ``lc = 2 pi c / wc``.  ``valid`` marks an idler of positive frequency."""
    w1, w2 = TWO_PI * C0 / lam_p1_m, TWO_PI * C0 / lam_p2_m
    w3 = TWO_PI * C0 / np.asarray(lam_s_m, dtype=np.float64)
    w4 = w1 + w2 - w3
    wc, wd = 0.5 * (w1 + w2), 0.5 * (w1 - w2)
    lc = TWO_PI * C0 / wc
    D = D_ps_nm_km * 1e-6          # ps/(nm km) -> s/m^2
    S = S_ps_nm2_km * 1e3          # ps/(nm^2 km) -> s/m^3
    b2 = -(lc * lc) / (TWO_PI * C0) * D
    b4 = -(lc ** 4) / (TWO_PI * C0) ** 3 * (6.0 * D + 6.0 * lc * S)
    om = w3 - wc
    db = b2 * (om ** 2 - wd ** 2) + b4 * (om ** 4 - wd ** 4) / 12.0
    return db, np.isfinite(w4) & (w4 > 0)


def rhs(b, gamma, alpha, dbeta):
    """The rotating-frame right-hand side over ``(B, 4)`` complex states;
    ``gamma``, ``alpha``, ``dbeta`` are ``(B,)``."""
    P = b.real * b.real + b.imag * b.imag
    F = 2.0 * P.sum(axis=1, keepdims=True) - P
    g, a = gamma[:, None], alpha[:, None]
    b1, b2, b3, b4 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    drive = np.stack([np.conj(b2) * b3 * b4, np.conj(b1) * b3 * b4,
                      np.conj(b4) * b1 * b2, np.conj(b3) * b1 * b2], axis=1)
    out = -0.5 * a * b + 1j * g * (F * b + 2.0 * drive)
    out[:, :2] -= 0.5j * dbeta[:, None] * b[:, :2]
    return out.astype(b.dtype, copy=False)


def _finite(y):
    return np.isfinite(y.real).all(axis=1) & np.isfinite(y.imag).all(axis=1)


def rk4(A0, gamma, alpha, dbeta, *, dz: float, n_steps: int, save_every: int,
        dtype=np.float64):
    """Fixed-step RK4: ``(P_max (B, 4), ok (B,))``, the running maximum of
    each wave's power over the saved samples (the initial state and every
    ``save_every``-th step) and whether every step stayed finite."""
    rdt = np.dtype(dtype)
    y = np.asarray(A0).astype(_complex(rdt))
    g, a, d = (np.asarray(v, dtype=rdt) for v in (gamma, alpha, dbeta))
    h, half = rdt.type(dz), rdt.type(0.5 * dz)
    pmax = (y.real ** 2 + y.imag ** 2)
    ok = np.ones(y.shape[0], dtype=bool)
    for step in range(1, n_steps + 1):
        k1 = rhs(y, g, a, d)
        k2 = rhs(y + half * k1, g, a, d)
        k3 = rhs(y + half * k2, g, a, d)
        k4 = rhs(y + h * k3, g, a, d)
        y_new = y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        fin = _finite(y_new)
        ok &= fin
        y = np.where(ok[:, None], y_new, y)
        if step % save_every == 0:
            pmax = np.maximum(pmax, y.real ** 2 + y.imag ** 2)
    return pmax, ok


# Dormand-Prince 5(4) tableau and the controller of the configuration's
# adaptive solve (rtol, atol): RMS error norm of |err| / (atol + rtol
# max(|y|, |y_new|)); step factor 0.9 err^(-1/5) clipped to [0.2, 5], 0.5
# on a non-finite attempt; the step carried across segments, clamped to the
# segment's end; the first step a tenth of the first segment; a lane fails
# when an attempt at dt <= 1e-12 (segment + 1) is rejected or a segment
# takes more than max_steps attempts.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
_DP_E = tuple(b5 - b4 for b5, b4 in zip(_DP_A[6] + (0.0,), _DP_B4))


def dp45(A0, gamma, alpha, dbeta, *, dz: float, n_steps: int, save_every: int,
         rtol: float, atol: float, max_steps: int = 1_000_000, dtype=np.float64):
    """Adaptive Dormand-Prince 5(4) over the save grid (``n_steps //
    save_every`` segments of ``save_every * dz``; a trailing remainder is
    integrated and feeds ``ok`` only): ``(P_max (B, 4), ok (B,), attempts
    (B,))``."""
    rdt = np.dtype(dtype)
    y = np.asarray(A0).astype(_complex(rdt))
    g, a, d = (np.asarray(v, dtype=rdt) for v in (gamma, alpha, dbeta))
    B = y.shape[0]
    n_seg, tail = divmod(int(n_steps), int(save_every))
    seg = float(save_every) * float(dz)
    spans = [seg] * n_seg + ([tail * float(dz)] if tail else [])
    pmax = y.real ** 2 + y.imag ** 2
    ok = np.ones(B, dtype=bool)
    attempts = np.zeros(B, dtype=np.int64)
    dt = np.full(B, 0.1 * spans[0], dtype=rdt)
    k1 = rhs(y, g, a, d)
    for i, length in enumerate(spans):
        L = rdt.type(length)
        dt_min = rdt.type(1e-12 * (length + 1.0))
        z = np.zeros(B, dtype=rdt)
        active = ok & (z < L)
        it = 0
        while it < max_steps and active.any():
            h = np.minimum(dt, L - z)[:, None]
            ks = [k1]
            for s in range(1, 7):
                yi = y
                for j, aij in enumerate(_DP_A[s]):
                    if aij != 0.0:
                        yi = yi + (h * rdt.type(aij)) * ks[j]
                ks.append(rhs(yi, g, a, d))
            y_new = yi
            err = np.zeros_like(y)
            for s, e in enumerate(_DP_E):
                if e != 0.0:
                    err = err + (h * rdt.type(e)) * ks[s]
            scale = atol + rtol * np.sqrt(np.maximum(np.abs(y) ** 2, np.abs(y_new) ** 2))
            r = np.where(scale > 0, np.abs(err) / np.where(scale > 0, scale, 1), 0)
            enorm = np.sqrt((r * r).sum(axis=1) / 4).astype(rdt)
            finite = np.isfinite(enorm) & _finite(y_new)
            accept = active & finite & (enorm <= 1)
            reject = active & ~accept
            with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
                factor = np.where(
                    finite, np.clip(0.9 * np.maximum(enorm, 1e-16) ** -0.2, 0.2, 5.0), 0.5)
            ok &= ~(reject & (h[:, 0] <= dt_min))
            dt = np.where(active, np.maximum(dt * factor.astype(rdt), dt_min), dt).astype(rdt)
            z = np.where(accept, z + h[:, 0], z)
            y = np.where(accept[:, None], y_new, y)
            k1 = np.where(accept[:, None], ks[6], k1)
            attempts += active
            it += 1
            active = ok & (z < L)
        ok &= z >= L
        if i < n_seg:
            pmax = np.maximum(pmax, y.real ** 2 + y.imag ** 2)
    return pmax, ok, attempts


def gain_db(p_max_signal, p_signal_0: float, ok):
    """The signal gain in dB over the saved maxima; NaN where a lane failed
    or the gain is not positive and finite."""
    g = np.where(ok, np.asarray(p_max_signal, dtype=np.float64) / p_signal_0, np.nan)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(np.isfinite(g) & (g > 0), 10.0 * np.log10(g), np.nan)
