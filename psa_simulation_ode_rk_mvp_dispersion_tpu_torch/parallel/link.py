"""Multi-span amplified links: lumped-amplifier chains on the Wigner engine.

A transmission link alternates fiber spans (loss, dispersion, Kerr --
everything the GNLSE engine integrates) with lumped optical amplifiers.
Each amplifier of power gain G maps the field operator as

    a_out = sqrt(G) a_in + sqrt(G - 1) b†,

so besides restoring the span loss it MUST inject amplified spontaneous
emission: in the truncated-Wigner representation the b† port adds a
complex Gaussian field of symmetric per-time-bin variance
``(G - 1) (2 n_sp - 1) sigma2`` where ``sigma2`` is the half-photon
vacuum variance and ``n_sp >= 1`` the spontaneous factor (ideal full
inversion: ``n_sp = 1``).  Propagating the pulse-family collective
coordinates through N spans realizes the classic soliton-link physics:

- the amplifier chain's noise figure follows the Friis-type cascade
  (for N transparent spans, input-referred NF = 1 + N (G-1)(2 n_sp - 1)
  in the bright-pulse limit);
- every amplifier kicks the pulse's center frequency, and dispersion
  converts each kick into timing drift over the REMAINING distance --
  the accumulated timing variance picks up ``sum_k (z_N - z_k)^2``,
  the **Gordon-Haus z^3 law** (Gordon & Haus, Opt. Lett. 11, 665
  (1986)) that sets the error-rate floor of soliton transmission.

The reference integrates a single CW 4-wave span (simulation.py) -- it
has no pulses, no amplifier model and no quantum noise; this module
composes the batched GNLSE solver (models/gnlse.py) with the Wigner
machinery (parallel/noise.py) into the system-level capability.

Counterpart of the JAX package's ``parallel/link.py``, plus ``device``
(``None``: the CUDA card).  Everything here is host-side composition: each
span is ONE batched solve over the whole ensemble (one
``csrc/gnlse_ssfm.cu`` launch on the card for the fixed-step Strang
span); the amplifier is a host-side affine map between spans, its ASE
drawn by the same ``np.random.default_rng`` stream as in the JAX package
(so the ensemble is the JAX package's, draw for draw).  ``mesh`` splits
each span's solve over its slots (``parallel/mesh.Mesh``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..config import SimulationConfig
from ..utils.checks import as_f64
from .noise import (
    PulseMomentStatistics,
    _moment_reduce,
    _seed_wigner,
)

__all__ = ["pulse_link_monte_carlo", "span_observed_length_m"]


def span_observed_length_m(cfg: SimulationConfig) -> float:
    """Length actually measured for one span under the framework-wide
    save-decimation contract: ``floor(n_steps / save_every) * save_every``
    fixed steps (trailing partial steps carry no saved state)."""
    n_steps = int(round(float(cfg.z_max) / float(cfg.dz)))
    n_obs = (n_steps // int(cfg.save_every)) * int(cfg.save_every)
    if n_obs < 1:
        raise ValueError(
            f"no saved grid points per span: {n_steps} steps with "
            f"save_every={cfg.save_every}"
        )
    return n_obs * float(cfg.dz)


def pulse_link_monte_carlo(
    cfg_span: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_spans: int,
    amp_gain: Optional[float] = None,
    n_sp: float = 1.0,
    ase: bool = True,
    n_samples: int = 1024,
    seed: int = 0,
    nl=None,
    mesh=None,
    device=None,
) -> PulseMomentStatistics:
    """Propagate a Wigner ensemble through ``n_spans`` identical fiber
    spans, each followed by a lumped amplifier, measuring the pulse
    collective coordinates (photon number, temporal centroid, spectral
    centroid -- see :class:`~.noise.PulseMomentStatistics`) at z = 0 and
    after every amplifier.

    ``cfg_span``/``coeffs`` describe ONE span (fixed-step; the span
    length is the last saved grid point, :func:`span_observed_length_m`).
    ``amp_gain`` is the power gain of each amplifier; the default
    ``None`` restores the span's flat loss exactly
    (``exp(alpha * L_span)`` -- a transparent link; spectral alpha
    requires an explicit gain).  ``n_sp >= 1`` is the spontaneous factor;
    ``ase=False`` drops the quantum-mandated injection (a mechanical
    control: the chain then unphysically preserves the input noise
    ellipse exactly).

    Returns statistics over the noisy lanes; lane 0 carries the
    noise-free mean field through the same chain (the ASE has zero mean,
    so amplification alone never perturbs it).
    """
    from ..models.gnlse import solve_gnlse_batch

    N = int(n_spans)
    if N < 1:
        raise ValueError("n_spans must be >= 1")
    if float(n_sp) < 1.0:
        raise ValueError("n_sp must be >= 1 (full inversion is 1)")

    z_span = span_observed_length_m(cfg_span)
    if amp_gain is None:
        alpha = as_f64(coeffs.alpha).cpu().numpy()   # a tensor on any device
        if alpha.ndim != 0:
            raise ValueError(
                "amp_gain=None (restore span loss) needs a flat scalar "
                f"alpha; got alpha shape {alpha.shape} -- pass amp_gain "
                "explicitly for spectral or per-instance loss"
            )
        G = float(np.exp(alpha * z_span))
    else:
        G = float(amp_gain)
    if G < 1.0:
        raise ValueError(f"amp_gain must be >= 1, got {G}")

    A0, A_batch, scale, sigma2, rng = _seed_wigner(
        A0, grid, omega0=omega0, n_samples=n_samples, seed=seed)
    # symmetric-ordering ASE variance per time bin [W]: (G-1)(2 n_sp - 1)
    # half-photons (b† port of the amplifier unitary)
    var_ase = (G - 1.0) * (2.0 * float(n_sp) - 1.0) * sigma2

    t0 = time.perf_counter()
    states = [A_batch]
    ok_all = np.ones(A_batch.shape[0], dtype=bool)
    A = A_batch
    for _ in range(N):
        _, A_end, ok = solve_gnlse_batch(cfg_span, coeffs, A, nl=nl,
                                         mesh=mesh, device=device)
        ok_all &= np.asarray(ok, dtype=bool)
        A = np.asarray(A_end, dtype=np.complex128) * np.sqrt(G)
        if ase and var_ase > 0.0:
            xi = rng.standard_normal(A[1:].shape) \
                + 1j * rng.standard_normal(A[1:].shape)
            A[1:] += xi * np.sqrt(var_ase / 2.0)
        states.append(A)
    elapsed = time.perf_counter() - t0
    if not ok_all[0]:
        raise FloatingPointError("the noise-free mean-field lane diverged")

    z = z_span * np.arange(N + 1, dtype=float)
    A_traj = np.stack(states, axis=1)                  # (B+1, N+1, T)
    return _moment_reduce(z, A_traj, ok_all, grid, scale, elapsed)
