"""Host-side matplotlib visualization of simulation and sweep results.

Capability parity with reference ``plotting.py``: the line-plot engine
(:83-139), ``plot_abs_matrix`` (:146), ``plot_power_matrix`` (:176-251),
``plot_total_powers_AB`` (:254-374), ``plot_abs_amplitudes`` (:381-413),
``plot_powers`` (:416), ``plot_signal_and_idler(_separate)`` (:454-545) and
the FWM+SBS forward/backward variants (:552-613) -- re-designed around ONE
scale-aware engine (the reference duplicates the linear/log/dBW switch in
three places, and its ``plot_abs_amplitudes`` crashes for scale='dbW',
``plotting.py:396-409`` -- fixed here: dB of amplitude is 20*log10|A|).

Framework additions: sweep plots (gain spectrum, gain+dbeta stacked panels
matching reference ``scan_mismtach.py:754-781``, mismatch scans, PSA phase
sweeps, 2-D gain maps).

Everything here operates on gathered host arrays -- plotting never touches
device code: the port's solvers return numpy arrays, and a caller holding a
tensor moves it to the host before plotting it.  A non-interactive backend
is selected automatically when no display is present.

This is the port's own copy of the JAX package's ``plotting.py`` (numpy at
module level, matplotlib imported at first use), so that the port imports
nothing of that package.  One difference: without matplotlib every
``plot_*`` function draws nothing, says so on stderr, naming the figure it
does not write, and returns None, so that a run on a machine that has no
matplotlib still computes and saves its data files.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import sys
from typing import Optional, Sequence, Tuple

import numpy as np


def _plt():
    import matplotlib

    if os.environ.get("DISPLAY", "") == "" and os.environ.get("MPLBACKEND", "") == "":
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


VALID_SCALES = ("linear", "log", "dbW")
WAVE_LABELS: Tuple[str, str, str, str] = ("pump 1", "pump 2", "signal", "idler")


# ---------------------------------------------------------------------------
# Validation + scale transforms
# ---------------------------------------------------------------------------

def _validate_xy(x, Y, *, name: str = "Y"):
    x = np.asarray(x, dtype=float)
    if x.ndim != 1 or x.size < 2:
        raise ValueError("x must be a 1D array with at least 2 points")
    Y = np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    if Y.ndim != 2:
        raise ValueError(f"{name} must be a 1D or 2D array")
    if Y.shape[0] != x.shape[0]:
        raise ValueError(f"{name}.shape[0] must match x.shape[0]")
    return x, Y


def _apply_scale(y: np.ndarray, scale: str, *, eps: float, db_factor: float):
    """Return (y_transformed, yscale_for_axis, ylabel_suffix)."""
    if scale == "linear":
        return y, "linear", ""
    if scale == "log":
        if eps <= 0:
            raise ValueError("eps must be > 0 for log scale")
        return np.maximum(y, eps), "log", ""
    if scale == "dbW":
        if eps <= 0:
            raise ValueError("eps must be > 0 for dBW scale")
        return db_factor * np.log10(np.maximum(y, eps)), "linear", " [dB]"
    raise ValueError(f"scale must be one of {VALID_SCALES}")


def _finish(plt, fig, *, title, save_path, show):
    if title is not None:
        fig.suptitle(title) if len(fig.axes) > 1 else fig.axes[0].set_title(title)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=200, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)


# ---------------------------------------------------------------------------
# Core line engine
# ---------------------------------------------------------------------------

def plot_lines(
    x,
    Y,
    *,
    labels: Sequence[str],
    xlabel: str = "z [m]",
    ylabel: str = "",
    scale: str = "linear",
    eps: float = 1e-30,
    db_factor: float = 10.0,
    title: Optional[str] = None,
    show: bool = True,
    save_path: Optional[str] = None,
    figsize: Tuple[float, float] = (8.0, 5.0),
):
    """One scale-aware multi-line plot; the engine behind everything else."""
    x, Y = _validate_xy(x, Y)
    if len(labels) != Y.shape[1]:
        raise ValueError("labels length must match number of columns")
    y_t, yscale, suffix = _apply_scale(
        np.asarray(Y, dtype=float), scale, eps=eps, db_factor=db_factor
    )
    plt = _plt()
    fig, ax = plt.subplots(figsize=figsize)
    for j, lab in enumerate(labels):
        ax.plot(x, y_t[:, j], label=lab)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel + suffix)
    ax.set_yscale(yscale)
    ax.grid(True, which="both", linestyle="--", alpha=0.5)
    ax.legend()
    _finish(plt, fig, title=title, save_path=save_path, show=show)


# ---------------------------------------------------------------------------
# Trajectory plots (reference API parity)
# ---------------------------------------------------------------------------

def plot_abs_matrix(z, Y, *, labels, title=None, show=True, save_path=None,
                    z_unit="m", ylabel="|Y(z)|"):
    z, Y = _validate_xy(z, Y)
    plot_lines(z, np.abs(Y), labels=labels, xlabel=f"z [{z_unit}]",
               ylabel=ylabel, title=title, show=show, save_path=save_path)


def plot_power_matrix(z, Y, *, labels, title=None, scale="linear", eps=1e-30,
                      show=True, save_path=None, z_unit="m",
                      ylabel="P(z) [W]"):
    """|Y|^2 vs z with linear/log/dbW scaling."""
    z, Y = _validate_xy(z, Y)
    plot_lines(z, np.abs(Y) ** 2, labels=labels, xlabel=f"z [{z_unit}]",
               ylabel=ylabel, scale=scale, eps=eps, db_factor=10.0,
               title=title, show=show, save_path=save_path)


def plot_abs_amplitudes(z, A, *, wave_labels=WAVE_LABELS, title=None,
                        scale="linear", eps=1e-30, show=True, save_path=None,
                        z_unit="m"):
    """|A_j(z)|; for scale='dbW' uses 20*log10|A| (dB of an amplitude --
    the case the reference leaves crashing, ``plotting.py:396-409``)."""
    z, A = _validate_xy(z, A, name="A")
    plot_lines(z, np.abs(A), labels=wave_labels, xlabel=f"z [{z_unit}]",
               ylabel="|A(z)|", scale=scale, eps=eps, db_factor=20.0,
               title=title, show=show, save_path=save_path)


def plot_powers(z, A, *, wave_labels=WAVE_LABELS, title=None, log_scale=False,
                log_eps=1e-30, show=True, save_path=None, z_unit="m"):
    plot_power_matrix(z, A, labels=wave_labels, title=title,
                      scale="log" if log_scale else "linear", eps=log_eps,
                      show=show, save_path=save_path, z_unit=z_unit)


def plot_signal_and_idler(z, A, *, wave_labels=("signal", "idler"), title=None,
                          log_scale=False, log_eps=1e-30, show=True,
                          save_path=None, z_unit="m"):
    z, A = _validate_xy(z, A, name="A")
    if A.shape[1] < 4:
        raise ValueError("A must have at least 4 wave columns")
    plot_power_matrix(z, A[:, 2:4], labels=wave_labels, title=title,
                      scale="log" if log_scale else "linear", eps=log_eps,
                      show=show, save_path=save_path, z_unit=z_unit)


def plot_signal_and_idler_separate(z, A, *, wave_labels=("signal", "idler"),
                                   title=None, log_scale=False, log_eps=1e-30,
                                   show=True, save_path_signal=None,
                                   save_path_idler=None, z_unit="m"):
    z, A = _validate_xy(z, A, name="A")
    for col, lab, sp in ((2, wave_labels[0], save_path_signal),
                         (3, wave_labels[1], save_path_idler)):
        t = None if title is None else f"{title} -- {lab}"
        plot_power_matrix(z, A[:, col:col + 1], labels=(lab,), title=t,
                          scale="log" if log_scale else "linear", eps=log_eps,
                          show=show, save_path=sp, z_unit=z_unit)


def plot_total_powers_AB(z, A, B, *, title="Total optical powers in A and B waves",
                         scale="linear", eps=1e-30, show=True, save_path=None,
                         z_unit="m", figsize=(8.0, 5.0)):
    """Total forward/backward powers sum_j|A_j|^2, sum_j|B_j|^2 vs z
    (the SBS-ready view, reference ``plotting.py:254-374``)."""
    z, A = _validate_xy(z, A, name="A")
    _, Bv = _validate_xy(z, B, name="B")
    P = np.stack([np.sum(np.abs(A) ** 2, axis=1),
                  np.sum(np.abs(Bv) ** 2, axis=1)], axis=-1)
    plot_lines(z, P, labels=(r"$\sum_j |A_j|^2$", r"$\sum_j |B_j|^2$"),
               xlabel=f"z [{z_unit}]", ylabel="Total power [W]", scale=scale,
               eps=eps, db_factor=10.0, title=title, show=show,
               save_path=save_path, figsize=figsize)


def plot_fwm_sbs_powers_forward(z, A, *, labels=("A1", "A2", "A3", "A4"),
                                title=None, scale="linear", eps=1e-30,
                                show=True, save_path=None, z_unit="km"):
    plot_power_matrix(z, A, labels=labels, title=title, scale=scale, eps=eps,
                      show=show, save_path=save_path, z_unit=z_unit,
                      ylabel="P_A(z) [W]")


def plot_fwm_sbs_powers_backward(z, B, *, labels=("B1", "B2", "B3", "B4"),
                                 title=None, scale="linear", eps=1e-30,
                                 show=True, save_path=None, z_unit="km"):
    plot_power_matrix(z, B, labels=labels, title=title, scale=scale, eps=eps,
                      show=show, save_path=save_path, z_unit=z_unit,
                      ylabel="P_B(z) [W]")


# ---------------------------------------------------------------------------
# Sweep plots (reference scan layer parity, data-first)
# ---------------------------------------------------------------------------

def plot_gain_spectrum(sweep, *, x_label=r"Signal wavelength $\lambda_3$ (nm)",
                       title="Maximum signal gain vs signal wavelength",
                       xscale="linear", yscale="linear", show=True,
                       save_path=None):
    """Gain-vs-x line plot of a SweepResult (reference
    ``scan_mismtach.py:412-428``)."""
    if yscale == "log" and sweep.gain_unit == "db":
        raise ValueError("yscale='log' is not supported with gain in dB; use linear gain")
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(sweep.x, sweep.gain, marker="o")
    ax.set_xlabel(x_label)
    unit = "dB" if sweep.gain_unit == "db" else "linear"
    ax.set_ylabel(f"Max signal gain ({unit})")
    ax.set_xscale(xscale)
    ax.set_yscale(yscale)
    ax.grid(True, which="both", alpha=0.3)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_gain_and_dbeta(sweep, *, gamma=None, p_pump_total=None,
                        x_label=r"Signal wavelength $\lambda_3$ (nm)",
                        length_unit="m",
                        title="Max signal gain and phase mismatch vs signal wavelength",
                        show=True, save_path=None):
    """Two stacked panels: gain and dbeta(lambda3), with the ideal-gain
    reference line dbeta = -gamma*(P1+P2) (reference
    ``scan_mismtach.py:754-781``; the reference draws this line with
    inconsistent signs in different plots, SURVEY.md section 8.4 -- the
    physically meaningful overlay for peak parametric gain is the negative
    one, kappa = dbeta + gamma(P1+P2) = 0)."""
    if sweep.dbeta is None:
        raise ValueError("SweepResult has no dbeta track; use plot_gain_spectrum")
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True, figsize=(9, 7))
    ax1.plot(sweep.x, sweep.gain, marker="o")
    unit = "dB" if sweep.gain_unit == "db" else "linear"
    ax1.set_ylabel(f"Max signal gain ({unit})")
    ax1.grid(True, which="both", alpha=0.3)

    ax2.plot(sweep.x, sweep.dbeta, marker="o", label=r"$\Delta\beta(\lambda_3)$")
    if gamma is not None and p_pump_total is not None:
        ref_line = -float(gamma) * float(p_pump_total)
        ax2.axhline(ref_line, ls="--", lw=2, label=r"$-\gamma(P_1+P_2)$")
    ax2.set_xlabel(x_label)
    ax2.set_ylabel(rf"$\Delta\beta$  [1/{length_unit}]")
    ax2.grid(True, which="both", alpha=0.3)
    ax2.legend()
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_mismatch_scan(signal_sweep, idler_sweep=None, *, length_unit="km",
                       title="Parametric gain vs phase mismatch", show=True,
                       save_path=None):
    """Gain vs provided dbeta with the best point marked (reference
    ``scan_mismtach.py:202-219``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    g = np.clip(signal_sweep.gain, 1e-20, None) \
        if signal_sweep.gain_unit == "linear" else signal_sweep.gain
    plot_fn = ax.semilogy if signal_sweep.gain_unit == "linear" else ax.plot
    plot_fn(signal_sweep.x, g, lw=2, label="Signal gain Gs")
    if idler_sweep is not None:
        gi = np.clip(idler_sweep.gain, 1e-20, None) \
            if idler_sweep.gain_unit == "linear" else idler_sweep.gain
        plot_fn(idler_sweep.x, gi, lw=2, ls="--", label="Idler level Gi")
    best = signal_sweep.best_index
    ax.axvline(signal_sweep.x[best], color="k", ls=":", lw=1.5,
               label=f"best = {signal_sweep.x[best]:.3g} 1/{length_unit}")
    ax.set_xlabel(rf"$\Delta\beta$  [1/{length_unit}]")
    ax.set_ylabel("Gain")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_phase_sweep(sweep, *, title="PSA gain vs input signal phase",
                     show=True, save_path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(sweep.x, sweep.gain, marker=".")
    ax.set_xlabel(r"Input signal phase $\phi_3$ [rad]")
    unit = "dB" if sweep.gain_unit == "db" else "linear"
    ax.set_ylabel(f"Signal gain ({unit})")
    ax.grid(True, alpha=0.3)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_gain_map(x, pump_powers, gain, *, gain_unit="dB",
                  x_label=r"Signal wavelength $\lambda_3$ (nm)",
                  title="Gain map: pump power x signal wavelength",
                  show=True, save_path=None):
    """2-D heatmap for gain_map_power_wavelength output."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 6))
    x = np.asarray(x, dtype=float)
    p = np.asarray(pump_powers, dtype=float)
    im = ax.pcolormesh(x, p, np.asarray(gain, dtype=float), shading="auto")
    fig.colorbar(im, ax=ax, label=f"Max signal gain ({gain_unit})")
    ax.set_xlabel(x_label)
    ax.set_ylabel("Pump power per pump [W]")
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_comb_spectrum(A, *, line_indices=None, title="Comb power spectrum",
                       floor_dbw=-120.0, show=True, save_path=None,
                       label=None):
    """Per-line power spectrum (dBW stems) of one or more comb states.

    ``A`` is (N,) for a single state or a list/stack of states (each plotted
    with its own label, e.g. input vs output)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 5))
    states = np.atleast_2d(np.asarray(A))
    labels = label if isinstance(label, (list, tuple)) else [label] * len(states)
    for st, lab in zip(states, labels):
        n = st.shape[-1]
        x = np.arange(n) if line_indices is None else np.asarray(line_indices)
        P_db = 10.0 * np.log10(np.maximum(np.abs(st) ** 2, 10 ** (floor_dbw / 10.0)))
        markerline, stemlines, _ = ax.stem(x, P_db, basefmt=" ", label=lab)
        plt.setp(markerline, markersize=3)
    ax.set_xlabel("Comb line index")
    ax.set_ylabel("Line power [dBW]")
    ax.set_ylim(bottom=floor_dbw)
    ax.grid(True, alpha=0.3)
    if any(lab is not None for lab in labels):
        ax.legend()
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_dbeta_spectrum(x, dbeta, *, gamma=None, p_pump_total=None,
                        x_label=r"Signal wavelength $\lambda_3$ (nm)",
                        length_unit="m", title=None, xscale="linear",
                        yscale="linear", show=True, save_path=None):
    """dbeta(lambda3) alone with the gamma*(P1+P2) overlay (the working
    counterpart of reference ``plot_dbeta_vs_lambda_signal``,
    scan_mismtach.py:473-585, whose helper stack crashes -- SURVEY.md 8.3).
    The overlay is drawn at -gamma*(P1+P2), the ideal-gain condition
    kappa = dbeta + gamma(P1+P2) = 0."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(np.asarray(x, float), np.asarray(dbeta, float),
            label=r"$\Delta\beta(\lambda_3)$")
    if gamma is not None and p_pump_total is not None:
        ax.axhline(-float(gamma) * float(p_pump_total), linestyle="--",
                   label=r"$-\gamma(P_1+P_2)$")
    ax.set_xlabel(x_label)
    ax.set_ylabel(rf"$\Delta\beta$ [1/{length_unit}]")
    ax.set_xscale(xscale)
    ax.set_yscale(yscale)
    ax.grid(True, which="both", linestyle="--", alpha=0.5)
    ax.legend()
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_pulse_evolution(z, t, A_saved, *, title="GNLSE pulse evolution",
                         t_unit="ps", floor_db=-60.0, show=True,
                         save_path=None):
    """|A(z, t)|^2 evolution map (dB rel. to the global peak) plus the input
    and output temporal profiles, for ``models/gnlse`` trajectories.

    ``A_saved`` is (S+1, T) complex on the decimated save grid ``z`` (S+1,),
    ``t`` the time axis in seconds."""
    plt = _plt()
    z = np.asarray(z, dtype=float)
    t = np.asarray(t, dtype=float)
    P = np.abs(np.asarray(A_saved)) ** 2
    if P.ndim != 2 or P.shape[0] != z.shape[0] or P.shape[1] != t.shape[0]:
        raise ValueError("A_saved must be (len(z), len(t))")
    t_scale = {"s": 1.0, "ps": 1e12, "fs": 1e15, "ns": 1e9}.get(t_unit)
    if t_scale is None:
        raise ValueError(f"Unsupported t_unit={t_unit!r}")
    P_db = 10.0 * np.log10(np.maximum(P / max(P.max(), 1e-300), 10 ** (floor_db / 10.0)))
    fig, (ax0, ax1) = plt.subplots(
        1, 2, figsize=(12, 5), gridspec_kw={"width_ratios": [2, 1]}
    )
    im = ax0.pcolormesh(t * t_scale, z, P_db, shading="auto")
    fig.colorbar(im, ax=ax0, label="|A|$^2$ [dB rel. peak]")
    ax0.set_xlabel(f"t [{t_unit}]")
    ax0.set_ylabel("z [m]")
    ax1.plot(t * t_scale, P[0], label="input")
    ax1.plot(t * t_scale, P[-1], label="output")
    ax1.set_xlabel(f"t [{t_unit}]")
    ax1.set_ylabel("|A|$^2$ [W]")
    ax1.grid(True, alpha=0.3)
    ax1.legend()
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_noise_figure_sweep(phases_rad, nf_db, gain_db, *,
                            pia_nf_db=None,
                            title="PSA noise figure vs input phase",
                            show=True, save_path=None):
    """Noise figure and gain vs input signal phase (the classic PSA
    figure: NF dips below the 3 dB PIA limit at the max-gain phase)."""
    plt = _plt()
    ph = np.rad2deg(np.asarray(phases_rad, dtype=float))
    nf = np.asarray(nf_db, dtype=float)
    g = np.asarray(gain_db, dtype=float)
    if nf.shape != ph.shape or g.shape != ph.shape:
        raise ValueError("phases, nf_db and gain_db must share a shape")
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(ph, nf, "o-", color="tab:blue", label="NF [dB]")
    if pia_nf_db is not None:
        ax.axhline(float(pia_nf_db), color="tab:blue", ls="--", alpha=0.6,
                   label="PIA limit")
    ax.axhline(0.0, color="gray", ls=":", alpha=0.6)
    ax.set_xlabel("input signal phase [deg]")
    ax.set_ylabel("noise figure [dB]", color="tab:blue")
    ax.grid(True, alpha=0.3)
    ax2 = ax.twinx()
    ax2.plot(ph, g, "s-", color="tab:orange", label="gain [dB]")
    ax2.set_ylabel("gain [dB]", color="tab:orange")
    lines, labels = ax.get_legend_handles_labels()
    l2, la2 = ax2.get_legend_handles_labels()
    ax.legend(lines + l2, labels + la2, loc="best")
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_noise_figure_spectrum(wavelength, nf_db, gain_db, *,
                               nf_theory_db=None, x_unit="nm",
                               title="Noise figure across the gain band",
                               show=True, save_path=None):
    """NF(lambda) and gain(lambda) for ``parallel/noise.noise_figure_spectrum``
    results, with an optional theory overlay (e.g. the PIA 2-1/G law)."""
    plt = _plt()
    x = np.asarray(wavelength, dtype=float)
    nf = np.asarray(nf_db, dtype=float)
    g = np.asarray(gain_db, dtype=float)
    if nf.shape != x.shape or g.shape != x.shape:
        raise ValueError("wavelength, nf_db and gain_db must share a shape")
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(x, nf, "o-", color="tab:blue", ms=3, label="NF (Monte Carlo)")
    if nf_theory_db is not None:
        ax.plot(x, np.asarray(nf_theory_db, dtype=float), "--",
                color="tab:blue", alpha=0.6, label="2 - 1/G theory")
    ax.axhline(0.0, color="gray", ls=":", alpha=0.6)
    ax.set_xlabel(f"signal wavelength [{x_unit}]")
    ax.set_ylabel("noise figure [dB]", color="tab:blue")
    ax.grid(True, alpha=0.3)
    ax2 = ax.twinx()
    ax2.plot(x, g, "s-", color="tab:orange", ms=3, label="gain [dB]")
    ax2.set_ylabel("gain [dB]", color="tab:orange")
    lines, labels = ax.get_legend_handles_labels()
    l2, la2 = ax2.get_legend_handles_labels()
    ax.legend(lines + l2, labels + la2, loc="best")
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_spectral_evolution(z, omega, A_saved, *,
                            lambda0_m=None,
                            title="GNLSE spectral evolution",
                            floor_db=-60.0, show=True, save_path=None):
    """|A(z, omega)|^2 evolution map (dB rel. to the global peak) plus the
    input and output spectra, for ``models/gnlse`` trajectories (the standard
    supercontinuum figure).

    ``A_saved`` is (S+1, T) complex on the save grid ``z``; ``omega`` the
    fft-ordered baseband axis (``TimeGrid.omega()``).  With ``lambda0_m``
    the x axis is absolute wavelength [nm] (points beyond the baseband's
    physical range are clipped); otherwise detuning [THz].
    """
    plt = _plt()
    z = np.asarray(z, dtype=float)
    om = np.fft.fftshift(np.asarray(omega, dtype=float))
    A = np.asarray(A_saved)
    if A.ndim != 2 or A.shape[0] != z.shape[0] or A.shape[1] != om.shape[0]:
        raise ValueError("A_saved must be (len(z), len(omega))")
    S = np.abs(np.fft.fftshift(np.fft.fft(A, axis=-1), axes=-1)) ** 2
    S_db = 10.0 * np.log10(
        np.maximum(S / max(S.max(), 1e-300), 10 ** (floor_db / 10.0))
    )
    if lambda0_m is not None:
        from .constants import c as _c

        w0 = 2.0 * np.pi * _c / float(lambda0_m)
        keep = om > -0.8 * w0  # clip unphysical negative absolute frequencies
        x = 2.0 * np.pi * _c / (w0 + om[keep]) * 1e9
        xlabel = "wavelength [nm]"
        S_db = S_db[:, keep]
        S_in, S_out = S[0][keep], S[-1][keep]
    else:
        x = om / (2.0 * np.pi) * 1e-12
        xlabel = "detuning [THz]"
        S_in, S_out = S[0], S[-1]
    fig, (ax0, ax1) = plt.subplots(
        1, 2, figsize=(12, 5), gridspec_kw={"width_ratios": [2, 1]}
    )
    im = ax0.pcolormesh(x, z, S_db, shading="auto")
    fig.colorbar(im, ax=ax0, label="spectral density [dB rel. peak]")
    ax0.set_xlabel(xlabel)
    ax0.set_ylabel("z [m]")
    floor = 10 ** (floor_db / 10.0) * max(S.max(), 1e-300)
    ax1.plot(x, 10 * np.log10(np.maximum(S_in, floor)), label="input")
    ax1.plot(x, 10 * np.log10(np.maximum(S_out, floor)), label="output")
    ax1.set_xlabel(xlabel)
    ax1.set_ylabel("spectral density [dB]")
    ax1.grid(True, alpha=0.3)
    ax1.legend()
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_gain_ripple(result, *, title="Gain distribution under delta-beta "
                     "fluctuations", show=True, save_path=None):
    """Histogram of the Monte-Carlo gain ensemble with the nominal gain,
    ensemble mean +- SE, and the p5/p95 yield band (order-statistic CIs
    shaded).  ``result`` is a :class:`~.parallel.fluctuations.GainRippleResult`."""
    import matplotlib.pyplot as plt

    g = np.asarray(result.gain_db)
    g = g[np.isfinite(g)]
    if g.size == 0:
        raise ValueError("no finite gains to plot")
    fig, ax = plt.subplots(figsize=(7, 4.2))
    ax.hist(g, bins=min(60, max(10, g.size // 20)), color="#4878cf",
            alpha=0.75, edgecolor="none")
    ax.axvline(result.gain_nominal_db, color="k", lw=1.5,
               label=f"nominal {result.gain_nominal_db:.2f} dB")
    ax.axvline(result.gain_mean_db, color="#d65f5f", lw=1.5,
               label=(f"mean {result.gain_mean_db:.2f} "
                      f"$\\pm$ {result.gain_mean_se_db:.3f} dB"))
    for p, ci, c in ((result.gain_p5_db, result.gain_p5_ci_db, "#6acc65"),
                     (result.gain_p95_db, result.gain_p95_ci_db, "#6acc65")):
        ax.axvline(p, color=c, lw=1.2, ls="--")
        ax.axvspan(ci[0], ci[1], color=c, alpha=0.2)
    ax.plot([], [], color="#6acc65", ls="--",
            label=f"p5/p95 [{result.gain_p5_db:.2f}, {result.gain_p95_db:.2f}] dB")
    ax.set_xlabel("Signal gain [dB]")
    ax.set_ylabel("Realizations")
    ax.legend(fontsize=9)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_squeezing_ellipses(sig_stats, joint_stats, *,
                            title="PSA vacuum squeezing: quadrature noise "
                            "ellipses", show=True, save_path=None):
    """Draw the 1-sigma noise ellipses of the single-signal mode and the
    joint (+45 deg) superposition mode against the vacuum circle (variance
    1/4 per quadrature).  Inputs are :class:`~.parallel.noise.QuadratureStats`."""
    import matplotlib.pyplot as plt

    th = np.linspace(0, 2 * np.pi, 200)
    fig, ax = plt.subplots(figsize=(5.2, 5.2))
    r_vac = np.sqrt(0.25)
    ax.plot(r_vac * np.cos(th), r_vac * np.sin(th), "k--", lw=1,
            label="vacuum (1/4)")

    def ellipse(st, color, label):
        # minor axis at theta_min with sd sqrt(v_min); major perpendicular
        a = np.sqrt(st.v_max)
        b = np.sqrt(st.v_min)
        ang = st.theta_min + np.pi / 2.0   # major-axis angle
        x = a * np.cos(th) * np.cos(ang) - b * np.sin(th) * np.sin(ang)
        y = a * np.cos(th) * np.sin(ang) + b * np.sin(th) * np.cos(ang)
        ax.plot(x, y, color=color, lw=1.6,
                label=f"{label}: {st.squeezing_db:+.1f} dB")

    ellipse(sig_stats, "#4878cf", "signal alone")
    ellipse(joint_stats, "#d65f5f", "joint (s+i)/sqrt(2)")
    ax.set_xlabel("X quadrature (photon units)")
    ax.set_ylabel("Y quadrature")
    ax.set_aspect("equal")
    ax.legend(fontsize=9)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_pulse_squeezing_evolution(ev, *,
                                   title="Pulse squeezing along the fiber",
                                   show=True, save_path=None):
    """Squeezing / antisqueezing (dB relative to vacuum) against propagation
    distance.  Input is :class:`~.parallel.noise.PulseSqueezingEvolution`;
    the dashed zero line is the vacuum, the dotted curve the minimum-
    uncertainty bound -10 log10(16 v_max) the squeezed quadrature cannot
    beat."""
    import matplotlib.pyplot as plt

    z = np.asarray(ev.z_m, dtype=float)
    fig, ax = plt.subplots(figsize=(6.4, 4.2))
    ax.axhline(0.0, color="k", ls="--", lw=1, label="vacuum")
    ax.plot(z, ev.antisqueezing_db, color="#d65f5f", lw=1.6,
            label="antisqueezing")
    ax.plot(z, ev.squeezing_db, color="#4878cf", lw=1.8, label="squeezing")
    ax.plot(z, -10.0 * np.log10(16.0 * np.asarray(ev.v_max)), color="0.5",
            ls=":", lw=1.2, label="min-uncertainty bound")
    k = ev.best_index
    ax.plot([z[k]], [ev.squeezing_db[k]], "o", color="#4878cf", ms=5)
    ax.annotate(f"{ev.squeezing_db[k]:+.1f} dB", (z[k], ev.squeezing_db[k]),
                textcoords="offset points", xytext=(6, -10), fontsize=9)
    ax.set_xlabel("z (m)")
    ax.set_ylabel("quadrature noise (dB rel. vacuum)")
    ax.legend(fontsize=9)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_photon_statistics(ph, *, title="Spectral photon-number statistics",
                           show=True, save_path=None):
    """Two panels from :class:`~.parallel.noise.PulsePhotonStatistics`:
    the mean photon spectrum (log) and the per-bin Fano factor against the
    shot-noise line, with the applied filter (if any) overlaid."""
    import matplotlib.pyplot as plt

    om = np.fft.fftshift(np.asarray(ph.omega, dtype=float))
    T = om.shape[0]
    # vector results stack (2, T) -> (2T,): split back into per-pol rows
    n_rows = np.asarray(ph.n_mean, dtype=float).reshape(-1, T)
    f_rows = np.asarray(ph.fano, dtype=float).reshape(-1, T)
    pol = ("", " (x)", " (y)") if n_rows.shape[0] > 1 else ("",)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(6.4, 5.6), sharex=True)
    for k in range(n_rows.shape[0]):
        ax1.semilogy(om, np.maximum(np.fft.fftshift(n_rows[k]), 1e-3),
                     color=("#4878cf", "#6acc65")[k % 2], lw=1.4,
                     label=None if n_rows.shape[0] == 1 else pol[k + 1])
    ax1.set_ylabel("photons / bin")
    if n_rows.shape[0] > 1:
        ax1.legend(fontsize=9)
    ax2.axhline(1.0, color="k", ls="--", lw=1, label="shot noise")
    # clip the MC-noise-negative Fano estimates of near-empty bins to the
    # axis floor instead of letting the log scale drop them silently
    floor = 1e-3
    for k in range(f_rows.shape[0]):
        ax2.plot(om, np.maximum(np.fft.fftshift(f_rows[k]), floor),
                 color=("#d65f5f", "#956cb4")[k % 2], lw=1.4,
                 label="per-bin Fano"
                 + (pol[k + 1] if f_rows.shape[0] > 1 else ""))
    if ph.filter_w is not None:
        w_rows = np.asarray(ph.filter_w, dtype=float).reshape(-1, T)
        for k in range(w_rows.shape[0]):
            ax2.plot(om, np.maximum(np.fft.fftshift(w_rows[k]), floor),
                     color="0.5", ls=(":", "-.")[k % 2], lw=1.2,
                     label="filter"
                     + (pol[k + 1] if w_rows.shape[0] > 1 else "")
                     + (f" (Fano {ph.filtered_fano:.2f})" if k == 0 else ""))
    ax2.set_yscale("log")
    ax2.set_xlabel("baseband angular frequency (rad/s)")
    ax2.set_ylabel("Fano factor")
    ax2.legend(fontsize=9)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_squeezing_spectrum(sp, *,
                            title="Sideband squeezing spectrum",
                            show=True, save_path=None):
    """Squeezing / antisqueezing (dB rel. vacuum) against baseband
    frequency from :class:`~.parallel.noise.SqueezingSpectrumResult`."""
    import matplotlib.pyplot as plt

    om = np.fft.fftshift(np.asarray(sp.omega, dtype=float))
    fig, ax = plt.subplots(figsize=(6.4, 4.2))
    ax.axhline(0.0, color="k", ls="--", lw=1, label="vacuum")
    ax.plot(om, np.fft.fftshift(np.asarray(sp.antisqueezing_db)),
            color="#d65f5f", lw=1.5, label="antisqueezing")
    ax.plot(om, np.fft.fftshift(np.asarray(sp.squeezing_db)),
            color="#4878cf", lw=1.5, label="squeezing")
    ax.set_xlabel("baseband angular frequency (rad/s)")
    ax.set_ylabel("sideband noise (dB rel. vacuum)")
    ax.legend(fontsize=9)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_spectral_coherence(res, *,
                            title="Shot-to-shot spectral coherence",
                            show=True, save_path=None):
    """Mean photon spectrum (log) with |g12(omega)| overlaid on a twin
    axis, from :class:`~.parallel.noise.CoherenceResult`."""
    import matplotlib.pyplot as plt

    om = np.fft.fftshift(np.asarray(res.omega, dtype=float))
    n = np.fft.fftshift(np.asarray(res.mean_photons, dtype=float))
    g = np.fft.fftshift(np.asarray(res.g12, dtype=float))
    fig, ax1 = plt.subplots(figsize=(6.4, 4.2))
    ax1.semilogy(om, np.maximum(n, 1e-3), color="#4878cf", lw=1.4,
                 label="mean spectrum")
    ax1.set_xlabel("baseband angular frequency (rad/s)")
    ax1.set_ylabel("photons / bin", color="#4878cf")
    ax2 = ax1.twinx()
    ax2.plot(om, g, color="#d65f5f", lw=1.5,
             label=f"|g12| (avg {res.g12_avg:.3f})")
    ax2.set_ylabel("|g12|", color="#d65f5f")
    ax2.set_ylim(-0.02, 1.05)
    lines = ax1.get_lines() + ax2.get_lines()
    ax1.legend(lines, [ln.get_label() for ln in lines], fontsize=9,
               loc="center right")
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_moment_statistics(ms, ms_loss=None, *, beta2_s2_m=None,
                           labels=("lossless", "langevin loss"),
                           title="Pulse timing / frequency jitter",
                           show=True, save_path=None):
    """Soliton-jitter observables from
    :class:`~.parallel.noise.PulseMomentStatistics`: the ensemble timing
    spread sigma_t(z) (top) against the EXACT lossless dispersive law
    ``Var_t(z) = Var_t(0) - 2 beta2 z Cov(t,f) + (beta2 z)^2 Var_f``
    implied by the z=0 moments (dashed; the law needs no linearization),
    and the frequency spread sigma_f(z) (bottom) -- flat for a lossless
    fiber, diffusing under distributed-loss vacuum injection (the
    Gordon-Haus mechanism).  Pass the langevin run as ``ms_loss`` to
    overlay both."""
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(6.4, 5.6), sharex=True)
    runs = [(ms, labels[0], "#4878cf")]
    if ms_loss is not None:
        runs.append((ms_loss, labels[1], "#d65f5f"))
    for m, lab, color in runs:
        z = np.asarray(m.z_m, dtype=float)
        ax1.plot(z, np.sqrt(np.asarray(m.t_var, dtype=float)) * 1e15,
                 color=color, lw=1.6, label=lab)
        ax2.plot(z, np.sqrt(np.asarray(m.f_var, dtype=float)) / 1e9,
                 color=color, lw=1.6, label=lab)
    # exact dispersive law from the z=0 moments of the FIRST run; when
    # beta2 is not given it is inferred from the measured covariance
    # drift (lossless: cov(z) = cov0 - beta2 z Var_f, so the terminal
    # slope pins beta2 without any physics input)
    m = ms
    z = np.asarray(m.z_m, dtype=float)
    if z.shape[0] >= 2 and float(m.f_var[0]) > 0.0:
        if beta2_s2_m is not None:
            beta2 = float(beta2_s2_m)
        else:
            dcov = (float(m.tf_cov[-1]) - float(m.tf_cov[0]))
            beta2 = (-dcov / (float(z[-1]) * float(m.f_var[0]))
                     if z[-1] else 0.0)
        pred = (float(m.t_var[0]) - 2.0 * beta2 * z * float(m.tf_cov[0])
                + (beta2 * z) ** 2 * float(m.f_var[0]))
        ax1.plot(z, np.sqrt(np.maximum(pred, 0.0)) * 1e15, color="0.4",
                 ls="--", lw=1.2, label="exact dispersive law")
    ax1.set_ylabel("timing spread $\\sigma_t$ (fs)")
    ax2.set_ylabel("frequency spread $\\sigma_f$ (Grad/s)")
    ax2.set_xlabel("z (m)")
    ax1.legend(fontsize=9)
    ax2.legend(fontsize=9)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


def plot_lle_scan(detuning, mean_power, *,
                  title="LLE laser scan: MI peak and soliton step",
                  show=True, save_path=None):
    """Intracavity mean power vs detuning from the LLE ramp protocol
    (``models/lle.run_lle_ramp``): the MI/chaotic peak inside the
    resonance followed by the characteristic soliton step."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(np.asarray(detuning), np.asarray(mean_power))
    ax.set_xlabel("detuning $\\Delta$ [half-linewidths]")
    ax.set_ylabel("intracavity power $\\langle|\\psi|^2\\rangle$")
    ax.grid(True, alpha=0.3)
    _finish(plt, fig, title=title, save_path=save_path, show=show)


# ---------------------------------------------------------------------------
# Without matplotlib
# ---------------------------------------------------------------------------

def _drawn_with_matplotlib(fn):
    """``fn`` when matplotlib can be imported; otherwise nothing is drawn,
    stderr says which figure is missing, and the call returns None."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if importlib.util.find_spec("matplotlib") is None:
            path = kwargs.get("save_path")
            print(f"plotting: matplotlib is not installed, so {fn.__name__} draws nothing"
                  + (f" and {path} is not written" if path else ""), file=sys.stderr)
            return None
        return fn(*args, **kwargs)

    return wrapped


for _name, _fn in list(globals().items()):
    if _name.startswith("plot_") and callable(_fn):
        globals()[_name] = _drawn_with_matplotlib(_fn)
del _name, _fn
