"""``parallel/calibrate`` against the JAX package on the CPU, the other
tiers: the lab-frame gain model (plain torch autograd through
``integrate_reduce``, no kernel), the x32 fit and the df32 hybrid.  Bars
and helpers: ``tests/test_torch_calibrate.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import calibrate as JC  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import calibrate as TC  # noqa: E402
from test_torch_calibrate import INIT, P_IN, TRUTH, _cfgs, _gain_parity, _rel  # noqa: E402


def test_lab_frame_gain_model_matches_jax():
    _gain_parity("lab")


def test_ten_step_x32_fit_matches_jax():
    """Ten adam steps at x32 on an x32 model's curve, at the JAX x32 test's
    bars: the loss history within 2e-3 (the gradient's bar; adam's steps
    are normalized by it) and the parameters within 2e-4 (the value's)."""
    cj, ct = _cfgs()
    db = np.linspace(-0.05, 0.03, 8)
    with torch.no_grad():
        curve = TC.make_gain_model(ct, p_in=P_IN, precision="x32", device="cpu")(T.RHSCoeffs(
            TRUTH["gamma"], TRUTH["alpha"], torch.tensor(db + TRUTH["dbeta_offset"])))
    kw = dict(delta_beta_grid=db, measured_gain_db=curve.double().numpy(), p_in=P_IN, init=INIT,
              steps=10, learning_rate=0.05, precision="x32")
    fj = J.fit_gain_curve(cj, **kw)
    ft = TC.fit_gain_curve(ct, **kw, device="cpu")
    assert ft.n_steps == fj.n_steps == 10 and ft.loss_history.shape == (11,)
    assert _rel(ft.loss_history, fj.loss_history) <= 2e-3
    for k in TRUTH:
        assert _rel(ft.params[k], fj.params[k]) <= 2e-4, k
    assert np.max(np.abs(ft.gain_db - fj.gain_db)) <= 2e-4 * np.max(np.abs(fj.gain_db))


def test_df32_fit_matches_jax():
    """The hybrid on the CPU branch of both packages (the x64 explore, the
    polish through the x64 engine): history and parameters to 1e-8."""
    cj, ct = _cfgs(dz=5.0, save_every=2)
    db = np.linspace(-0.05, 0.03, 8)
    ej = JC._engine_gain_curve_fn(cj, db, p_in=P_IN, phase_in=None, wave=2,
                                  forward_precision="x64")
    curve = ej(np.array([[np.log(TRUTH["gamma"]), TRUTH["alpha"] * 100.0,
                          TRUTH["dbeta_offset"] * 100.0]]))[0]
    kw = dict(delta_beta_grid=db, measured_gain_db=curve, p_in=P_IN, init=INIT, steps=10,
              learning_rate=0.05, precision="df32", polish_iters=3)
    fj = J.fit_gain_curve(cj, **kw)
    ft = TC.fit_gain_curve(ct, **kw, device="cpu")
    assert ft.n_steps == fj.n_steps and ft.loss_history.shape == fj.loss_history.shape
    assert _rel(ft.loss_history, fj.loss_history) <= 1e-8
    for k in TRUTH:
        assert _rel(ft.params[k], fj.params[k]) <= 1e-8, k
