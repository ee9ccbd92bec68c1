"""The port's 4-wave Monte Carlo (``parallel/noise.py``, section 1) against
the JAX package's, on the CPU.

Both packages draw every ensemble from ``np.random.default_rng(seed)`` on
the host, in the same order and shapes, so the same seed gives the same
ensemble; the port (``device='cpu'``, the plain torch solver) is then held
to the JAX package (x64) at the solvers' own tolerance, field by field:

- every gain (``gain_db``, ``gain_nominal_db`` and the like) within
  1e-9 dB;
- every other dB figure (noise figures, their jackknife SE, squeezing)
  within 1e-6 dB, absolute: the bar ``tests/test_noise.py`` holds two
  layouts of one ensemble to (near the 0 dB PSA limit a relative bar
  means nothing);
- every other float within 1e-9 relative (ensemble moments, photon
  numbers, angles; ``atol`` 1e-300 only so that exact zeros compare),
  but the RIN transfer coefficients, within 1e-9 of their largest entry
  (the PIA signal's own transfer is ~1e-9 dB/dB, a difference of near
  equal gradients), and the ensemble means and covariance of the moment
  statistics' zero-centred coordinates (``t_mean``, ``f_mean``,
  ``tf_cov``), within 1e-9 of their ensemble spread (the square roots of
  ``t_var`` and ``f_var``): their means are small sums of large
  terms;
- the figures whose rounding follows the host (XLA's CPU code rounds by
  the host's vector ISA, torch's does not), each within 1e-9 of the
  scale it is defined on: a quadrature mean (``mean_re``, ``mean_im``)
  of its own modulus, but no less than the ensemble spread
  ``sqrt(v_max)`` (the mean normal to the LO is near zero by
  construction); a squeezing angle ``theta_min`` of pi radians,
  absolute, where the noise ellipse has an axis (``v_max - v_min`` at
  least 1e-6 of ``v_max + v_min``); per-bin photon statistics normwise,
  ``n_mean`` within 1e-9 of its largest modulus and ``fano`` within
  1e-9 of its largest value on the bright bins (``n_mean`` above 1e-6
  of its largest value; a comb's lines above 1e-6 W: a vacuum bin's Fano
  is a ratio of two near-zero moments), and Fano's NaN mask on the bins
  whose ``n_mean`` is resolved (its modulus above 1e-9 of the largest:
  below it, ``n_mean > 0`` is the sign of a rounding);
- ``ok`` masks, counts, names identical; ``elapsed_s`` and
  ``points_per_s`` (wall clock) skipped.

``precision='df32'`` runs float64 in the port (the JAX package's two-float
tier has no port) and is held to JAX x64 at the same bars.  The errors the
JAX functions raise, the port raises with the same type and message; a
``mesh`` that is not a ``parallel/mesh.Mesh`` raises a TypeError.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_tpu as J  # noqa: E402
import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import noise as JN  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import noise as TN  # noqa: E402

torch.set_num_threads(1)

GAIN_DB_ABS = 1e-9
DB_ABS = 1e-6
REL = 1e-9
SKIP = ("elapsed_s", "points_per_s")
NORMWISE = ("transfer_db_per_db", "transfer_se", "transfer_autodiff")
SPREAD = {"t_mean": ("t_var",), "f_mean": ("f_var",), "tf_cov": ("t_var", "f_var")}
AXIS = 1e-6       # least (v_max - v_min) / (v_max + v_min) at which theta_min is defined
BRIGHT = 1e-6     # fano held above this fraction of the largest n_mean (a comb: this many W)
OMEGA = np.asarray(J.plan_from_wavelengths(1550e-9, 1552e-9, 1551.0e-9))
GAMMA, P_PUMP = 5e-3, 0.5


def _is_gain(name):
    return "gain" in name and name.endswith("_db")


def compare(got, ref, path="result"):
    """Hold a port result (dataclass, tuple, array or scalar) to the JAX
    package's at the bars of the module docstring."""
    if dataclasses.is_dataclass(ref):
        assert type(got).__name__ == type(ref).__name__, path
        held = _compare_on_scale(got, ref, path)
        for f in dataclasses.fields(ref):
            if f.name in SPREAD:
                scale = np.prod([np.sqrt(np.max(getattr(ref, v))) for v in SPREAD[f.name]])
                np.testing.assert_allclose(getattr(got, f.name), getattr(ref, f.name), rtol=0,
                                           atol=REL * scale, err_msg=f"{path}.{f.name}")
            elif f.name not in SKIP and f.name not in held:
                _compare_field(getattr(got, f.name), getattr(ref, f.name), f"{path}.{f.name}",
                               f.name)
    elif isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            compare(g, r, f"{path}[{i}]")
    else:
        _compare_field(got, ref, path, path.rsplit(".", 1)[-1])


def _hold(got, ref, atol, path):
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, equal_nan=True, err_msg=path)


def _compare_on_scale(got, ref, path):
    """Hold the fields of a result whose scale is not their own value (the
    module docstring): quadrature means, squeezing angles, per-bin photon
    statistics.  Returns the names of the fields it held."""
    names = {f.name for f in dataclasses.fields(ref)}
    g, r = (lambda n: np.asarray(getattr(got, n))), (lambda n: np.asarray(getattr(ref, n)))
    held = set()
    if {"mean_re", "mean_im", "v_max"} <= names:
        for n in ("mean_re", "mean_im"):
            _hold(g(n), r(n), REL * np.maximum(np.abs(r(n)), np.sqrt(r("v_max"))),
                  f"{path}.{n}")
        held |= {"mean_re", "mean_im"}
    if {"theta_min", "v_min", "v_max"} <= names:
        axis = r("v_max") - r("v_min") >= AXIS * (r("v_max") + r("v_min"))
        _hold(g("theta_min")[axis], r("theta_min")[axis], REL * np.pi, f"{path}.theta_min")
        held.add("theta_min")
    if {"n_mean", "fano"} <= names:
        n_mean, top = r("n_mean"), np.max(np.abs(r("n_mean")))
        _hold(g("n_mean"), n_mean, REL * top, f"{path}.n_mean")
        unit = ref.t_mode_s / (T.constants.hbar * r("omega")) if "t_mode_s" in names else top
        bright = n_mean > BRIGHT * unit
        if bright.any():
            _hold(g("fano")[bright], r("fano")[bright], REL * np.max(np.abs(r("fano")[bright])),
                  f"{path}.fano")
        resolved = np.abs(n_mean) > REL * top
        np.testing.assert_array_equal(np.isnan(g("fano"))[resolved],
                                      np.isnan(r("fano"))[resolved], err_msg=f"{path}.fano")
        held |= {"n_mean", "fano"}
    return held


def _compare_field(got, ref, path, name):
    if dataclasses.is_dataclass(ref) or isinstance(ref, tuple) and ref and \
            not isinstance(ref[0], (str, float, int, np.floating)):
        compare(got, ref, path)
        return
    if ref is None or isinstance(ref, (str, bool, np.bool_)) or (
            isinstance(ref, tuple) and ref and isinstance(ref[0], str)):
        assert got == ref, f"{path}: {got!r} != {ref!r}"
        return
    g, r = np.asarray(got), np.asarray(ref)
    assert g.shape == r.shape, f"{path}: shape {g.shape} != {r.shape}"
    if r.dtype == bool or r.dtype.kind in "iu":
        np.testing.assert_array_equal(g, r, err_msg=path)
    elif name in NORMWISE:
        np.testing.assert_allclose(g, r, rtol=0, atol=REL * np.max(np.abs(r)), err_msg=path)
    elif _is_gain(name):
        np.testing.assert_allclose(g, r, rtol=0, atol=GAIN_DB_ABS, equal_nan=True, err_msg=path)
    elif name.endswith("_db"):
        np.testing.assert_allclose(g, r, rtol=0, atol=DB_ABS, equal_nan=True, err_msg=path)
    else:
        np.testing.assert_allclose(g, r, rtol=REL, atol=1e-300, equal_nan=True, err_msg=path)


def cfgs(**kw):
    """The same configuration in both packages: (JAX, port)."""
    port_kw = dict(kw)
    jax_kw = dict(kw, precision="x64") if kw.get("precision") == "df32" else kw
    return J.custom_simulation_config(**jax_kw), T.custom_simulation_config(**port_kw)


def both(name, cfg_pair, *args, **kw):
    """Run ``name`` of the noise module in both packages: (JAX, port)."""
    cj, ct = cfg_pair
    return (getattr(JN, name)(cj, *args, **kw),
            getattr(TN, name)(ct, *args, device="cpu", **kw))


NF_CASES = {
    "pia": dict(p_in=[P_PUMP, P_PUMP, 1e-6, 0.0], measure="signal", seed=1),
    "psa-joint": dict(p_in=[P_PUMP, P_PUMP, 5e-7, 5e-7], phase_in=[0, 0, 1.1, 0],
                      measure="signal+idler", seed=2),
    "all-noisy": dict(p_in=[P_PUMP, P_PUMP, 1e-6, 0.0], measure="signal+idler", seed=4,
                      noisy_waves=(True, True, True, True)),
    "langevin": dict(p_in=[P_PUMP, P_PUMP, 1e-6, 0.0], measure="signal", seed=5,
                     alpha=2e-3, loss_model="langevin", n_loss_segments=4),
}


@pytest.mark.parametrize("case", sorted(NF_CASES))
@pytest.mark.parametrize("precision", ["x64", "df32"])
def test_noise_figure_matches_jax(case, precision):
    kw = dict(gamma=GAMMA, alpha=0.0, omega=OMEGA, delta_beta=0.0, n_samples=64,
              noisy_waves=(False, False, True, True))
    kw.update(NF_CASES[case])
    rj, rt = both("noise_figure_monte_carlo",
                  cfgs(z_max=20.0, dz=0.05, save_every=50, precision=precision), **kw)
    compare(rt, rj)
    assert rt.n_samples == 64 and np.isfinite(rt.nf_se_db)


def test_noise_figure_spectrum_matches_jax():
    """Five signal wavelengths across a dispersion-shaped band: one batched
    solve of 5 x 17 lanes, the plan and the mismatch on the host."""
    lam3 = np.linspace(1545e-9, 1640e-9, 5)
    _, _, dj = J.experiments._dispersion_at_pump_center(1550e-9, 1555e-9, float(lam3[0]),
                                                        D=0.2, S=0.02)
    _, _, dt = T.experiments._dispersion_at_pump_center(1550e-9, 1555e-9, float(lam3[0]),
                                                        D=0.2, S=0.02)
    cj, ct = cfgs(z_max=20.0, dz=0.05, save_every=50)
    kw = dict(lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=lam3, gamma=0.05,
              alpha=0.0, p_in=[P_PUMP, P_PUMP, 1e-6, 0.0], length_unit="m", n_samples=16,
              measure="signal", seed=7)
    rj = JN.noise_figure_spectrum(cj, dispersion=dj, **kw)
    rt = TN.noise_figure_spectrum(ct, dispersion=dt, device="cpu", **kw)
    compare(rt, rj)
    assert rt.ok.all() and np.all(np.isfinite(rt.nf_db))


@pytest.mark.parametrize("loss", ["deterministic", "langevin"])
def test_psa_squeezing_matches_jax(loss):
    kw = dict(gamma=GAMMA, alpha=2e-3 if loss == "langevin" else 0.0, omega=OMEGA,
              p_pump_W=P_PUMP, n_samples=64, seed=3, loss_model=loss, n_loss_segments=4)
    rj, rt = both("psa_squeezing_monte_carlo", cfgs(z_max=20.0, dz=0.05, save_every=50),
                  **kw)
    compare(rt, rj)


@pytest.mark.parametrize("loss", ["deterministic", "langevin"])
def test_epr_matches_jax(loss):
    kw = dict(gamma=GAMMA, alpha=2e-3 if loss == "langevin" else 0.0, omega=OMEGA,
              p_pump_W=P_PUMP, n_samples=64, seed=6, loss_model=loss, n_loss_segments=4)
    rj, rt = both("epr_inseparability_monte_carlo", cfgs(z_max=20.0, dz=0.05, save_every=50),
                  **kw)
    compare(rt, rj)
    assert rt.entangled == rj.entangled


def test_pump_rin_transfer_matches_jax():
    """The regression on the same jittered launches, and the autodiff
    transfer (torch autograd through the plain RK4 here, jax.grad there)."""
    kw = dict(gamma=0.05, alpha=0.0, delta_beta=0.0, p_in=[P_PUMP, P_PUMP, 1e-6, 0.0],
              n_samples=64, seed=3, rel_sigma=1e-3)
    rj, rt = both("pump_rin_transfer_monte_carlo", cfgs(z_max=5.0, dz=0.05, save_every=20),
                  **kw)
    compare(rt, rj)
    assert rt.transfer_autodiff[3] == 0.0 and rt.transfer_autodiff[0] > 0.0


def test_quadrature_stats_match_jax():
    rng = np.random.default_rng(0)
    u = rng.standard_normal(256) * 0.7 + 1j * rng.standard_normal(256) * 0.3 + 2.0
    compare(TN.quadrature_stats_u(u), JN.quadrature_stats_u(u))
    compare(TN.quadrature_stats(u * 1e-5, 1.2e15, 1e-9),
            JN.quadrature_stats(u * 1e-5, 1.2e15, 1e-9))
    for fn in (TN.quadrature_stats_u, JN.quadrature_stats_u):
        with pytest.raises(ValueError, match=">= 2 samples"):
            fn(np.ones(1))


_NF = dict(gamma=GAMMA, alpha=0.0, omega=OMEGA, delta_beta=0.0)
_SPEC = dict(lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=[1552e-9], gamma=0.0115,
             alpha=0.0)
_SQ = dict(gamma=GAMMA, alpha=0.0, omega=OMEGA, p_pump_W=P_PUMP)
_RIN = dict(gamma=GAMMA, alpha=0.0, delta_beta=0.0, p_in=[P_PUMP, P_PUMP, 1e-6, 0.0])
VALIDATION = {
    "nf-measure": ("noise_figure_monte_carlo", ValueError, "measure",
                   dict(_NF, p_in=[0.5, 0.5, 1e-6, 0], measure="signal+junk")),
    "nf-n-samples": ("noise_figure_monte_carlo", ValueError, "n_samples",
                     dict(_NF, p_in=[0.5, 0.5, 1e-6, 0], n_samples=1)),
    "nf-t-mode": ("noise_figure_monte_carlo", ValueError, "t_mode_s",
                  dict(_NF, p_in=[0.5, 0.5, 1e-6, 0], t_mode_s=0.0)),
    "nf-no-input": ("noise_figure_monte_carlo", ValueError, "no input power",
                    dict(_NF, p_in=[0.5, 0.5, 0.0, 0.0], measure="signal", n_samples=16)),
    "nf-quiet-wave": ("noise_figure_monte_carlo", ValueError, "vacuum noise",
                      dict(_NF, p_in=[0.5, 0.5, 1e-6, 0], measure="pump1",
                           noisy_waves=(False, False, True, True))),
    "nf-loss-model": ("noise_figure_monte_carlo", ValueError, "loss_model",
                      dict(_NF, p_in=[0.5, 0.5, 1e-6, 0], loss_model="lossy")),
    "nf-mean-field": ("noise_figure_monte_carlo", FloatingPointError, "mean-field",
                      dict(_NF, gamma=1e6, alpha=-100.0, p_in=[10.0, 10.0, 1.0, 0.0],
                           n_samples=16)),
    "nf-langevin-gain": ("noise_figure_monte_carlo", ValueError, "alpha >= 0",
                         dict(_NF, alpha=-1e-3, p_in=[0.5, 0.5, 1e-6, 0], n_samples=16,
                              loss_model="langevin", n_loss_segments=4)),
    "nf-langevin-segments": ("noise_figure_monte_carlo", ValueError, "must divide",
                             dict(_NF, alpha=1e-3, p_in=[0.5, 0.5, 1e-6, 0], n_samples=16,
                                  loss_model="langevin", n_loss_segments=7)),
    "spectrum-no-input": ("noise_figure_spectrum", ValueError, "nonzero input power",
                          dict(_SPEC, p_in=[0.5, 0.5, 0.0, 0.0], measure="signal")),
    "spectrum-quiet-wave": ("noise_figure_spectrum", ValueError, "vacuum noise",
                            dict(_SPEC, p_in=[0.5, 0.5, 1e-7, 0.0], measure="pump1")),
    "squeezing-n-samples": ("psa_squeezing_monte_carlo", ValueError, "n_samples",
                            dict(_SQ, n_samples=8)),
    "epr-loss-model": ("epr_inseparability_monte_carlo", ValueError, "loss_model",
                       dict(_SQ, loss_model="lossy")),
    "rin-no-power": ("pump_rin_transfer_monte_carlo", ValueError, "no input power",
                     dict(_RIN, wave=3)),
    "rin-n-samples": ("pump_rin_transfer_monte_carlo", ValueError, ">= 64",
                      dict(_RIN, n_samples=32)),
    "rin-sigma": ("pump_rin_transfer_monte_carlo", ValueError, "rel_sigma",
                  dict(_RIN, rel_sigma=0.7)),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_matches_jax(case):
    name, exc, match, kw = VALIDATION[case]
    cj, ct = cfgs(z_max=5.0, dz=0.05, save_every=50)
    with pytest.raises(exc, match=match) as ej:
        getattr(JN, name)(cj, **kw)
    with pytest.raises(exc, match=match) as et:
        getattr(TN, name)(ct, device="cpu", **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name, kw", [
    ("noise_figure_monte_carlo", dict(_NF, p_in=[0.5, 0.5, 1e-6, 0], n_samples=16)),
    ("noise_figure_spectrum", dict(_SPEC, p_in=[0.5, 0.5, 1e-6, 0.0], n_samples=16)),
    ("psa_squeezing_monte_carlo", dict(_SQ, n_samples=16)),
    ("epr_inseparability_monte_carlo", dict(_SQ, n_samples=16)),
    ("pump_rin_transfer_monte_carlo", dict(_RIN, n_samples=64)),
])
def test_mesh_is_refused(name, kw):
    _, ct = cfgs(z_max=5.0, dz=0.05, save_every=50)
    with pytest.raises(TypeError, match="mesh must be"):
        getattr(TN, name)(ct, mesh=object(), device="cpu", **kw)


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` is the CUDA card: without one the ensemble is not
    run on the CPU behind the caller's back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ct = cfgs(z_max=5.0, dz=0.05, save_every=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TN.noise_figure_monte_carlo(ct, p_in=[0.5, 0.5, 1e-6, 0], n_samples=16, **_NF)
