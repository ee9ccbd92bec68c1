"""The port's pulse, vector and comb Monte Carlo (``parallel/noise.py``,
sections 2-5) against the JAX package's, on the CPU.

The same seed draws the same Wigner ensemble in both packages
(``np.random.default_rng`` on the host, the same order and shapes), so the
port (``device='cpu'``, the plain torch solvers) is held to the JAX package
(x64) at the bars of ``test_torch_noise.py``: gains within 1e-9 dB, other
dB figures within 1e-6 dB, other floats within 1e-9 relative, ``ok``
identical, ``elapsed_s`` skipped; the moment statistics' means on the
scale of their spread.  The per-line photon statistics of the comb are
held normwise, within 1e-9 of their largest value (``n_mean``, and
``fano`` on the lines that carry more than 1e-6 W: a vacuum line's Fano is
a ratio of two near-zero moments, and a noiseless pump's a small
variance over a large mean).  Small sizes: T = 32-128 samples, 32-160 lanes, a
fraction of a soliton period.  Each function's errors are the JAX
function's, and a ``mesh`` that is not a ``parallel/mesh.Mesh`` is
refused with a TypeError.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_tpu as J  # noqa: E402
import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import noise as JN  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import noise as TN  # noqa: E402
from test_torch_noise import compare  # noqa: E402

torch.set_num_threads(1)

OM0, T0, BETA2, GAMMA = 1.2e15, 1e-12, -2.0e-26, 2e-3
Z_PERIOD = 0.5 * np.pi * T0 ** 2 / abs(BETA2)


def pulse_setup(P, n=128, alpha=0.0, alpha_spec=None, periods=0.5, steps=200, save_every=50,
                beta2=BETA2, cw=False):
    """(grid, coeffs, A0, cfg) in package ``P``: a fundamental soliton (or
    a 1 W CW pump) over ``periods`` soliton periods."""
    grid = P.gnlse.TimeGrid.for_pulse(T0, n_samples=n)
    disp = P.DispersionParams.from_betas(OM0, beta2=beta2)
    kw = dict(gamma_W_m=GAMMA, alpha_1_m=alpha)
    if alpha_spec is not None:
        kw = dict(gamma_W_m=GAMMA, alpha_spec_1_m=alpha_spec)
    co = P.make_gnlse_coeffs(grid, disp, **kw)
    if cw:
        A0 = np.full(n, 1.0, dtype=complex)
    else:
        A0 = np.asarray(P.sech_pulse(grid, peak_W=P.soliton_peak_power(beta2, GAMMA, T0),
                                     t0_s=T0))
    z = periods * Z_PERIOD
    cfg = P.custom_simulation_config(z_max=z, dz=z / steps, save_every=save_every)
    return grid, co, A0, cfg


def both(name, setup_kw=None, **kw):
    """Run the noise function ``name`` on the same pulse setup in both
    packages: (JAX, port)."""
    gj, cj, Aj, fj = pulse_setup(J, **(setup_kw or {}))
    gt, ct, At, ft = pulse_setup(T, **(setup_kw or {}))
    return (getattr(JN, name)(fj, cj, Aj, gj, omega0=OM0, **kw),
            getattr(TN, name)(ft, ct, At, gt, omega0=OM0, device="cpu", **kw))


def _lo(case, n=128):
    if case == "explicit":
        return np.exp(-np.linspace(-3, 3, n) ** 2) * (1 + 0.5j)
    return case


@pytest.mark.parametrize("lo", ["mean-output", "mean-input", "explicit"])
def test_pulse_squeezing_matches_jax(lo):
    rj, rt = both("pulse_squeezing_monte_carlo", n_samples=32, seed=0, lo_mode=_lo(lo))
    compare(rt, rj)


@pytest.mark.parametrize("loss", ["flat", "spectral"])
def test_pulse_squeezing_langevin_matches_jax(loss):
    kw = (dict(alpha=2e-3) if loss == "flat" else
          dict(alpha_spec=np.linspace(1e-3, 3e-3, 128)))
    rj, rt = both("pulse_squeezing_monte_carlo", setup_kw=kw, n_samples=32, seed=1,
                  loss_model="langevin", n_loss_segments=4)
    compare(rt, rj)


def test_pulse_squeezing_with_raman_matches_jax():
    nlj = J.make_nl_terms(J.gnlse.TimeGrid.for_pulse(T0, n_samples=128), f_raman=0.18,
                          omega0=OM0)
    nlt = T.make_nl_terms(T.gnlse.TimeGrid.for_pulse(T0, n_samples=128), f_raman=0.18,
                          omega0=OM0)
    gj, cj, Aj, fj = pulse_setup(J)
    gt, ct, At, ft = pulse_setup(T)
    rj = JN.pulse_squeezing_monte_carlo(fj, cj, Aj, gj, omega0=OM0, n_samples=32, seed=2,
                                        nl=nlj)
    rt = TN.pulse_squeezing_monte_carlo(ft, ct, At, gt, omega0=OM0, n_samples=32, seed=2,
                                        nl=nlt, device="cpu")
    compare(rt, rj)


@pytest.mark.parametrize("loss", ["deterministic", "langevin"])
def test_pulse_squeezing_evolution_matches_jax(loss):
    rj, rt = both("pulse_squeezing_evolution", setup_kw=dict(alpha=2e-3), n_samples=32, seed=3,
                  loss_model=loss)
    compare(rt, rj)
    assert rt.z_m.shape == (5,)


@pytest.mark.parametrize("filt", ["none", "mask"])
def test_pulse_photon_statistics_matches_jax(filt):
    kw = dict(filter_mask=np.exp(-np.fft.fftfreq(128) ** 2 * 50)) if filt == "mask" else {}
    rj, rt = both("pulse_photon_statistics", n_samples=32, seed=4, **kw)
    compare(rt, rj)


def test_pulse_photon_statistics_optimal_filter_matches_jax():
    """The out-of-sample optimal filter needs n_samples >= 4 T: T = 32."""
    rj, rt = both("pulse_photon_statistics", setup_kw=dict(n=32), n_samples=160, seed=5,
                  optimal_filter=True)
    compare(rt, rj)
    assert rt.filter_w.max() == 1.0


@pytest.mark.parametrize("coherence", [False, True])
def test_pulse_squeezing_spectrum_matches_jax(coherence):
    """A CW pump in the anomalous regime: the modulation-instability band."""
    rj, rt = both("pulse_squeezing_spectrum", setup_kw=dict(cw=True, periods=2.0),
                  n_samples=32, seed=6, return_coherence=coherence)
    compare(rt, rj)


def test_pulse_coherence_matches_jax():
    rj, rt = both("pulse_coherence_monte_carlo", n_samples=32, seed=7)
    compare(rt, rj)


@pytest.mark.parametrize("loss", ["deterministic", "langevin"])
def test_pulse_moment_statistics_matches_jax(loss):
    rj, rt = both("pulse_moment_statistics", setup_kw=dict(alpha=2e-3), n_samples=32, seed=8,
                  loss_model=loss)
    compare(rt, rj)


def vector_setup(P, n=64, coupling="manakov", alpha=0.0):
    grid = P.gnlse.TimeGrid.for_pulse(T0, n_samples=n)
    disp = P.DispersionParams.from_betas(OM0, beta2=BETA2)
    co = P.make_vgnlse_coeffs(grid, disp, gamma_W_m=GAMMA, coupling=coupling, alpha_1_m=alpha)
    A0 = P.polarized_pulse(P.sech_pulse(grid, peak_W=2.0, t0_s=T0), 0.4)
    cfg = P.custom_simulation_config(z_max=50.0, dz=50.0 / 80, save_every=20)
    return grid, co, np.asarray(A0), cfg


def vboth(name, setup_kw=None, **kw):
    gj, cj, Aj, fj = vector_setup(J, **(setup_kw or {}))
    gt, ct, At, ft = vector_setup(T, **(setup_kw or {}))
    return (getattr(JN, name)(fj, cj, Aj, gj, omega0=OM0, **kw),
            getattr(TN, name)(ft, ct, At, gt, omega0=OM0, device="cpu", **kw))


@pytest.mark.parametrize("case", ["manakov-jones", "isotropic", "langevin"])
def test_vector_pulse_squeezing_matches_jax(case):
    ones = np.ones(64, complex)
    if case == "manakov-jones":
        rj, rt = vboth("vector_pulse_squeezing_monte_carlo", n_samples=32, seed=0,
                       lo_mode=np.stack([ones, -ones]))
    elif case == "isotropic":
        rj, rt = vboth("vector_pulse_squeezing_monte_carlo", setup_kw=dict(coupling="isotropic"),
                       n_samples=32, seed=1)
    else:
        rj, rt = vboth("vector_pulse_squeezing_monte_carlo", setup_kw=dict(alpha=2e-3),
                       n_samples=32, seed=2, loss_model="langevin", n_loss_segments=4,
                       lo_mode="mean-input")
    compare(rt, rj)


@pytest.mark.parametrize("loss", ["deterministic", "langevin"])
def test_vector_pulse_squeezing_evolution_matches_jax(loss):
    rj, rt = vboth("vector_pulse_squeezing_evolution", setup_kw=dict(alpha=2e-3), n_samples=32,
                   seed=3, loss_model=loss)
    compare(rt, rj)


@pytest.mark.parametrize("filt", ["shared", "per-polarization"])
def test_vector_pulse_photon_statistics_matches_jax(filt):
    w = np.exp(-np.fft.fftfreq(64) ** 2 * 50)
    mask = w if filt == "shared" else np.stack([w, 0.5 * w])
    rj, rt = vboth("vector_pulse_photon_statistics", n_samples=32, seed=4, filter_mask=mask)
    compare(rt, rj)


def test_vector_pulse_coherence_matches_jax():
    rj, rt = vboth("vector_pulse_coherence_monte_carlo", n_samples=32, seed=5)
    compare(rt, rj)


def comb_setup(P, A0_extra=None):
    nw = P.nwave
    grid = nw.CombGrid.centered(2 * np.pi * 193.1e12, 2 * np.pi * 100e9, 4)
    cfg = P.custom_simulation_config(z_max=40.0, dz=0.05, save_every=100)
    co = nw.NWaveCoeffs(gamma=5e-3, alpha=0.0, beta_lin=np.zeros(4))
    A0 = np.asarray(nw.seed_comb(grid, pump_lines={0: 0.5, 3: 0.5, 1: 1e-6}))
    return grid, co, A0, cfg


def _compare_comb(rt, rj):
    """The comb's per-line photon statistics normwise (and Fano on the
    lines above 1e-6 W), everything else at the module bars."""
    bright = rj.n_mean > 1e-6 * rj.t_mode_s / (T.constants.hbar * rj.omega)
    np.testing.assert_allclose(rt.n_mean, rj.n_mean, rtol=0,
                               atol=1e-9 * np.max(np.abs(rj.n_mean)))
    np.testing.assert_allclose(rt.fano[bright], rj.fano[bright], rtol=0,
                               atol=1e-9 * np.max(np.abs(rj.fano[bright])))
    np.testing.assert_array_equal(np.isnan(rt.fano), np.isnan(rj.fano))
    for f in ("omega", "nf_db", "nf_se_db", "gain_db", "measure_lines", "n_samples",
              "ok_fraction", "t_mode_s"):
        compare(getattr(rt, f), getattr(rj, f), f"result.{f}")


@pytest.mark.parametrize("lines", [None, (1,), (1, 2)])
def test_comb_photon_statistics_matches_jax(lines):
    gj, cj, Aj, fj = comb_setup(J)
    gt, ct, At, ft = comb_setup(T)
    kw = dict(n_samples=32, seed=1, noisy_lines=[False, True, True, False], measure_lines=lines)
    rj = JN.comb_photon_statistics(fj, cj, gj, Aj, **kw)
    rt = TN.comb_photon_statistics(ft, ct, gt, At, device="cpu", **kw)
    _compare_comb(rt, rj)
    assert (rt.nf_db is None) == (lines is None)


def test_comb_pair_squeezing_matches_jax():
    gj, cj, Aj, fj = comb_setup(J)
    gt, ct, At, ft = comb_setup(T)
    kw = dict(pair=(1, 2), n_samples=32, seed=0, noisy_lines=[False, True, True, False])
    compare(TN.comb_pair_squeezing_monte_carlo(ft, ct, gt, At, device="cpu", **kw),
            JN.comb_pair_squeezing_monte_carlo(fj, cj, gj, Aj, **kw))


def _pulse_call(P, mod, name, **kw):
    grid, co, A0, cfg = pulse_setup(P, n=32)
    A0 = kw.pop("A0", A0)
    return getattr(mod, name)(cfg, co, A0, grid, omega0=OM0, **kw)


def _vector_call(P, mod, name, **kw):
    grid, co, A0, cfg = vector_setup(P)
    A0 = kw.pop("A0", A0)
    return getattr(mod, name)(cfg, co, A0, grid, omega0=OM0, **kw)


def _comb_call(P, mod, name, **kw):
    grid, co, A0, cfg = comb_setup(P)
    A0 = kw.pop("A0", A0)
    return getattr(mod, name)(cfg, co, grid, A0, **kw)


VALIDATION = {
    "pulse-lo-mode": (_pulse_call, "pulse_squeezing_monte_carlo", ValueError, "lo_mode",
                      dict(n_samples=16, lo_mode="bogus")),
    "pulse-n-samples": (_pulse_call, "pulse_squeezing_monte_carlo", ValueError, "n_samples",
                        dict(n_samples=8)),
    "pulse-loss-model": (_pulse_call, "pulse_photon_statistics", ValueError, "loss_model",
                         dict(n_samples=16, loss_model="lossy")),
    "pulse-filter-negative": (_pulse_call, "pulse_photon_statistics", ValueError, "filter_mask",
                              dict(n_samples=16, filter_mask=-np.ones(32))),
    "pulse-filter-and-optimal": (_pulse_call, "pulse_photon_statistics", ValueError,
                                 "filter_mask OR", dict(n_samples=16, optimal_filter=True,
                                                        filter_mask=np.ones(32))),
    "pulse-optimal-too-few": (_pulse_call, "pulse_photon_statistics", ValueError, "4\\*T",
                              dict(n_samples=64, optimal_filter=True)),
    "pulse-langevin-segments": (_pulse_call, "pulse_squeezing_monte_carlo", ValueError,
                                "must divide", dict(n_samples=16, loss_model="langevin",
                                                    n_loss_segments=7)),
    "evolution-loss-model": (_pulse_call, "pulse_squeezing_evolution", ValueError, "loss_model",
                             dict(n_samples=16, loss_model="lossy")),
    "moments-n-samples": (_pulse_call, "pulse_moment_statistics", ValueError, "n_samples",
                          dict(n_samples=4)),
    "vector-shape": (_vector_call, "vector_pulse_squeezing_monte_carlo", ValueError,
                     r"\(2, T\)", dict(n_samples=16, A0=np.ones(64, complex))),
    "vector-filter-shape": (_vector_call, "vector_pulse_photon_statistics", ValueError,
                            "filter_mask", dict(n_samples=16, filter_mask=np.ones(7))),
    "comb-masked-line": (_comb_call, "comb_photon_statistics", ValueError, "measure_lines",
                         dict(n_samples=16, noisy_lines=[False, True, True, False],
                              measure_lines=[0])),
    "comb-lines": (_comb_call, "comb_photon_statistics", ValueError, "lines",
                   dict(n_samples=16, A0=np.ones(3, complex))),
    "comb-t-mode": (_comb_call, "comb_photon_statistics", ValueError, "t_mode_s",
                    dict(n_samples=16, t_mode_s=0.0)),
    "comb-pair": (_comb_call, "comb_pair_squeezing_monte_carlo", ValueError, "pair",
                  dict(n_samples=16, pair=(1, 7))),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_matches_jax(case):
    call, name, exc, match, kw = VALIDATION[case]
    with pytest.raises(exc, match=match) as ej:
        call(J, JN, name, **dict(kw))
    with pytest.raises(exc, match=match) as et:
        call(T, TN, name, device="cpu", **dict(kw))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("call, name", [
    (_pulse_call, "pulse_squeezing_monte_carlo"), (_pulse_call, "pulse_squeezing_evolution"),
    (_pulse_call, "pulse_photon_statistics"), (_pulse_call, "pulse_squeezing_spectrum"),
    (_pulse_call, "pulse_coherence_monte_carlo"), (_pulse_call, "pulse_moment_statistics"),
    (_vector_call, "vector_pulse_squeezing_monte_carlo"),
    (_vector_call, "vector_pulse_photon_statistics"),
    (_vector_call, "vector_pulse_coherence_monte_carlo"),
    (_comb_call, "comb_photon_statistics"), (_comb_call, "comb_pair_squeezing_monte_carlo"),
])
def test_mesh_is_refused(call, name):
    kw = dict(pair=(1, 2)) if name == "comb_pair_squeezing_monte_carlo" else {}
    with pytest.raises(TypeError, match="mesh must be"):
        call(T, TN, name, n_samples=16, mesh=object(), device="cpu", **kw)
