"""The recovery bars of ``tests/test_calibrate.py`` on the port, on the CPU
at a small configuration: 100 m of fibre in 10 RK4 steps (5 for the df32
hybrid), 8 points of the mismatch grid, and for the pulse 40 Strang steps
over half a soliton period.  Each synthetic curve comes from the same
configuration, so recovering its parameters still means what it means in
the JAX test, whose bars these are: the adam fits (400 steps) to rms 0.05
dB, gamma 5% and the offset 10% with the loss down 1e-3; the df32 hybrid
to rms 1e-4 dB, gamma 1e-4, offset 1e-3 and alpha 1e-2 with its polish
1e-2 below the explore's best; the gradient against central differences
1e-6; the pump-RIN Monte Carlo against the exact transfer within 4 SE or
2e-3; the pulse-spectrum fit (400 steps) to rms 0.5 dB, gamma 15% and
beta2 12%.  The JAX test's own sizes run on the card (``chip_smoke.py``
phase 29)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tgn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import calibrate as TC  # noqa: E402

P_IN = [0.5, 0.5, 1e-5, 0.0]
TRUTH = dict(gamma=0.0115, alpha=2.0e-4, dbeta_offset=-3e-3)
INIT = dict(gamma=0.008, alpha=0.0, dbeta_offset=0.0)
DB = np.linspace(-0.05, 0.03, 8)


def _cfg(dz=10.0):
    return T.custom_simulation_config(z_max=100.0, dz=dz, save_every=1)


def _curve(cfg, precision):
    with torch.no_grad():
        g = TC.make_gain_model(cfg, p_in=P_IN, precision=precision, device="cpu")
        return g(T.RHSCoeffs(TRUTH["gamma"], TRUTH["alpha"],
                             torch.tensor(DB + TRUTH["dbeta_offset"]))).double().numpy()


def _fit(cfg, curve, precision, steps):
    return TC.fit_gain_curve(cfg, delta_beta_grid=DB, measured_gain_db=curve, p_in=P_IN,
                             init=INIT, steps=steps, learning_rate=0.05, precision=precision,
                             device="cpu")


@pytest.mark.parametrize("precision", ["x64", "x32"])
def test_fit_recovers_synthetic_gain_curve(precision):
    cfg = _cfg()
    fit = _fit(cfg, _curve(cfg, precision), precision, 400)
    assert np.sqrt(fit.loss_db2) < 0.05
    assert fit.params["gamma"] == pytest.approx(TRUTH["gamma"], rel=0.05)
    assert fit.params["dbeta_offset"] == pytest.approx(TRUTH["dbeta_offset"], rel=0.10)
    assert fit.gain_db.shape == DB.shape and fit.loss_history.shape == (401,)
    if precision == "x64":
        assert fit.loss_history[-1] < 1e-3 * fit.loss_history[0]


def test_df32_hybrid_reaches_oracle_grade():
    cfg = _cfg(dz=5.0)
    gen = TC._engine_gain_curve_fn(cfg, DB, p_in=P_IN, phase_in=None, wave=2,
                                   forward_precision="x64", device="cpu")
    curve = gen(np.array([[np.log(TRUTH["gamma"]), TRUTH["alpha"] * 100.0,
                           TRUTH["dbeta_offset"] * 100.0]]))[0]
    steps = 100
    fit = _fit(cfg, curve, "df32", steps)
    assert np.sqrt(fit.loss_db2) < 1e-4
    assert fit.params["gamma"] == pytest.approx(TRUTH["gamma"], rel=1e-4)
    assert fit.params["dbeta_offset"] == pytest.approx(TRUTH["dbeta_offset"], rel=1e-3)
    assert fit.params["alpha"] == pytest.approx(TRUTH["alpha"], rel=1e-2)
    assert fit.loss_history[-1] < 1e-2 * np.min(fit.loss_history[:steps + 1])


def test_gradient_matches_finite_difference_and_x32_matches_x64():
    cfg = T.custom_simulation_config(z_max=100.0, dz=1.0, save_every=10)
    gain = TC.make_gain_model(cfg, p_in=P_IN, device="cpu")
    co = dict(alpha=2e-4, delta_beta=-3e-3)
    gm = torch.tensor(0.0115, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(gain(T.RHSCoeffs(gamma=gm, **co)), gm)
    eps = 1e-7
    with torch.no_grad():
        fd = (float(gain(T.RHSCoeffs(gamma=0.0115 + eps, **co)))
              - float(gain(T.RHSCoeffs(gamma=0.0115 - eps, **co)))) / (2 * eps)
    assert float(g) == pytest.approx(fd, rel=1e-6)
    al = torch.tensor(2e-4, dtype=torch.float64, requires_grad=True)
    (ga,) = torch.autograd.grad(gain(T.RHSCoeffs(gamma=0.0115, alpha=al, delta_beta=-3e-3)), al)
    assert float(ga) < 0.0
    # the x32 tier against the x64 oracle: value and gradient
    g32 = TC.make_gain_model(cfg, p_in=P_IN, precision="x32", device="cpu")
    gm32 = torch.tensor(0.0115, dtype=torch.float32, requires_grad=True)
    v32 = g32(T.RHSCoeffs(gamma=gm32, **co))
    (gr32,) = torch.autograd.grad(v32, gm32)
    with torch.no_grad():
        v64 = float(gain(T.RHSCoeffs(gamma=0.0115, **co)))
    assert float(v32.detach()) == pytest.approx(v64, rel=2e-4, abs=1e-4)
    assert float(gr32) == pytest.approx(float(g), rel=2e-3)


def test_pump_rin_transfer_matches_autodiff():
    """The Monte-Carlo slopes reproduce ``power_transfer_db_per_db``, and
    gamma = 0 transfers nothing (``pump_rin_transfer_monte_carlo`` takes
    its exact transfer from ``calibrate`` now)."""
    cfg = T.custom_simulation_config(z_max=100.0, dz=2.0, save_every=10)
    kw = dict(gamma=0.0115, alpha=2e-4, delta_beta=-3e-3, p_in=[0.5, 0.5, 1e-5, 0.0])
    r = T.pump_rin_transfer_monte_carlo(cfg, n_samples=4096, seed=0, device="cpu", **kw)
    dev = np.abs(r.transfer_db_per_db - r.transfer_autodiff)
    assert np.all(dev < np.maximum(4.0 * r.transfer_se, 2e-3))
    assert r.transfer_autodiff[0] > 0.5 and abs(r.transfer_autodiff[2]) < 1e-3
    assert r.transfer_db_per_db[3] == 0.0 and r.gain_std_db > 0.0
    np.testing.assert_array_equal(
        r.transfer_autodiff, TC.power_transfer_db_per_db(cfg, **kw, device="cpu"))
    r0 = T.pump_rin_transfer_monte_carlo(cfg, n_samples=1024, seed=1, gamma=0.0, alpha=2e-4,
                                         delta_beta=0.0, p_in=[0.5, 0.5, 1e-5, 0.0],
                                         device="cpu")
    assert np.all(np.abs(r0.transfer_autodiff) < 1e-9)
    assert np.all(np.abs(r0.transfer_db_per_db) < 1e-6)


def test_pulse_spectrum_fit_recovers_gamma_and_beta2():
    T0 = 1e-12
    grid = tgn.TimeGrid.for_pulse(T0, n_samples=128)
    truth = dict(gamma=2e-3, beta2=-2e-26)
    P0 = T.soliton_peak_power(truth["beta2"], truth["gamma"], T0) * 2.25
    A0 = np.asarray(T.sech_pulse(grid, peak_W=P0, t0_s=T0))
    zs = 0.5 * np.pi * T0 ** 2 / abs(truth["beta2"])
    cfg = T.custom_simulation_config(z_max=zs, dz=zs / 40, save_every=40)
    field = TC.make_pulse_model(cfg, grid, A0, device="cpu")
    with torch.no_grad():
        y = field(truth).numpy()

    def f(b2):
        return field({"gamma": truth["gamma"], "beta2": b2})[0].abs() ** 2

    b2 = torch.tensor(truth["beta2"], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(f(b2), b2)
    eps = 1e-31
    with torch.no_grad():
        fd = (float(f(truth["beta2"] + eps)) - float(f(truth["beta2"] - eps))) / (2 * eps)
    assert float(g) == pytest.approx(fd, rel=1e-4)
    meas = 10 * np.log10(np.maximum(np.abs(np.fft.fft(y)) ** 2, 1e-300))
    fit = TC.fit_pulse_spectrum(cfg, grid, A0, meas, init=dict(gamma=1.4e-3, beta2=-2.8e-26),
                                steps=400, learning_rate=0.1, device="cpu")
    assert np.sqrt(fit.loss_db2) < 0.5
    assert fit.params["gamma"] == pytest.approx(truth["gamma"], rel=0.15)
    assert fit.params["beta2"] == pytest.approx(truth["beta2"], rel=0.12)
    with pytest.raises(ValueError, match="gamma"):
        TC.fit_pulse_spectrum(cfg, grid, A0, meas, init=dict(beta2=-2e-26), device="cpu")
