"""``parallel/calibrate`` of the PyTorch port against the JAX package's, on
the CPU: the same inputs through both, the JAX side under x64 as
``tests/test_calibrate.py`` runs it.

Bars: the 4-wave models, their gradients (torch autograd through the
tangent RK4's plain version here, ``jax.grad`` of the ``lax.scan`` there)
and the transfers agree to rel 1e-10 -- both differentiate the same
discrete RK4 map in float64, in other orders of operations; the pulse
model's field to 1e-12 and its gradient to 1e-8; the adam steps to rel
1e-15 (the same arithmetic); ten-step fits in loss history and parameters
to rel 1e-9 (x64), and at the JAX x32 test's bars (2e-4 on values, 2e-3 on
gradients) in float32; the df32 hybrid's engine curve to 1e-12 dB and its
Levenberg-Marquardt polish to 1e-8.  Each new JAX program compiles for
~14 s on the CPU, so the comparisons are spread over files:
``tests/test_torch_calibrate_tiers.py`` (x32, the lab frame, the df32
fit), ``tests/test_torch_calibrate_pulse.py`` (the pulse model and the
transfers) and ``tests/test_torch_calibrate_recovery.py`` (the recovery
bars of ``tests/test_calibrate.py``, port only); the 400-step fits of
``tests/test_calibrate.py`` run on the card (``chip_smoke.py`` phase 29)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import gnlse as jgn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops.rhs import RHSCoeffs as JR  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import calibrate as JC  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tgn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import calibrate as TC  # noqa: E402

P_IN = [0.5, 0.5, 1e-5, 0.0]
TRUTH = dict(gamma=0.0115, alpha=2.0e-4, dbeta_offset=-3e-3)
INIT = dict(gamma=0.008, alpha=0.0, dbeta_offset=0.0)


def _cfgs(**kw):
    kw = dict(dict(z_max=100.0, dz=1.0, save_every=10), **kw)   # test_calibrate._cfg()
    return J.custom_simulation_config(**kw), T.custom_simulation_config(**kw)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), np.finfo(float).tiny)))


def _t(v, requires_grad=False):
    return torch.tensor(v, dtype=torch.float64, requires_grad=requires_grad)


def _gain_parity(frame, n_pts=3):
    """The gain model at ``n_pts`` random coefficient triples, value and
    gradient against ``jax.value_and_grad``, and the same points as one
    ``(B,)`` call; rel 1e-10."""
    cj, ct = _cfgs()
    gj = J.make_gain_model(cj, p_in=P_IN, frame=frame)
    gt = TC.make_gain_model(ct, p_in=P_IN, frame=frame, device="cpu")
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(8e-3, 1.4e-2, n_pts), rng.uniform(0.0, 4e-4, n_pts),
                    rng.uniform(-0.05, 0.03, n_pts)])
    vg = jax.jit(jax.value_and_grad(lambda x: gj(JR(gamma=x[0], alpha=x[1], delta_beta=x[2]))))
    values = []
    for g, a, d in pts.T:
        vj, grj = vg(jnp.asarray([g, a, d]))
        values.append(float(vj))
        x = _t([g, a, d], requires_grad=True)
        vt = gt(T.RHSCoeffs(x[0], x[1], x[2]))
        (grt,) = torch.autograd.grad(vt, x)
        assert _rel(float(vt.detach()), float(vj)) <= 1e-10
        assert _rel(grt.numpy(), np.asarray(grj)) <= 1e-10
    # every point in one call: the fields as (B,) tensors
    with torch.no_grad():
        curve = gt(T.RHSCoeffs(*(torch.tensor(r) for r in pts)))
    assert curve.shape == (n_pts,) and _rel(curve.numpy(), values) <= 1e-10


def test_gain_model_value_and_gradient_match_jax():
    _gain_parity("rotating")


def test_adam_matches_optax_on_a_fixed_gradient_sequence():
    """``_Adam`` is ``optax.adam(optax.cosine_decay_schedule(lr, steps))``:
    the same parameters after each of 60 steps of a fixed gradient
    sequence (past the schedule's end, where the rate stays 0)."""
    rng = np.random.default_rng(1)
    grads = rng.standard_normal((60, 3)) * np.array([1e-2, 3.0, 40.0])
    theta0 = np.array([np.log(0.008), 0.0, 0.3])
    opt = optax.adam(optax.cosine_decay_schedule(0.05, 50))
    th_j = {"a": jnp.asarray(theta0)}
    st = opt.init(th_j)
    mine = TC._Adam(0.05, 50, _t(theta0))
    th_t = _t(theta0)
    for g in grads:
        upd, st = opt.update({"a": jnp.asarray(g)}, st, th_j)
        th_j = optax.apply_updates(th_j, upd)
        th_t = mine.update(th_t, _t(g))
        assert _rel(th_t.numpy(), np.asarray(th_j["a"])) <= 1e-15


def test_ten_step_fit_matches_jax():
    """Ten adam steps at x64 from test_calibrate's start: the same loss
    history and parameters to rel 1e-9."""
    cj, ct = _cfgs()
    db = np.linspace(-0.05, 0.03, 8)
    with torch.no_grad():
        curve = TC.make_gain_model(ct, p_in=P_IN, device="cpu")(T.RHSCoeffs(
            TRUTH["gamma"], TRUTH["alpha"], torch.tensor(db + TRUTH["dbeta_offset"]))).numpy()
    kw = dict(delta_beta_grid=db, measured_gain_db=curve, p_in=P_IN, init=INIT, steps=10,
              learning_rate=0.05, precision="x64")
    fj = J.fit_gain_curve(cj, **kw)
    ft = TC.fit_gain_curve(ct, **kw, device="cpu")
    assert ft.n_steps == fj.n_steps == 10 and ft.loss_history.shape == (11,)
    assert _rel(ft.loss_history, fj.loss_history) <= 1e-9
    for k in TRUTH:
        assert _rel(ft.params[k], fj.params[k]) <= 1e-9, k
    assert _rel(ft.gain_db, fj.gain_db) <= 1e-9 and _rel(ft.loss_db2, fj.loss_db2) <= 1e-9


def test_df32_engine_curve_and_polish_match_jax():
    """The hybrid's two host pieces: the engine curve (``sweep.solve_batch``
    at x64, the CPU branch of both packages) to 1e-12 dB, and the LM polish
    from the same theta_0 through each package's engine to 1e-8."""
    cj, ct = _cfgs()
    db = np.linspace(-0.05, 0.03, 8)
    kw = dict(p_in=P_IN, phase_in=None, wave=2, forward_precision="x64")
    ej = JC._engine_gain_curve_fn(cj, db, **kw)
    et = TC._engine_gain_curve_fn(ct, db, **kw, device="cpu")
    th = np.array([[np.log(TRUTH["gamma"]), TRUTH["alpha"] * 100.0, TRUTH["dbeta_offset"] * 100.0],
                   [np.log(0.011), 0.01, -0.2]])
    assert np.max(np.abs(et(th) - ej(th))) <= 1e-12
    target = ej(th[:1])[0]
    theta0 = np.array([np.log(0.0112), 0.0, -0.25])
    th_j, hist_j = JC._lm_polish_gain_curve(ej, theta0, target, tol_db=1e-7, max_iters=4)
    th_t, hist_t = TC._lm_polish_gain_curve(et, theta0, target, tol_db=1e-7, max_iters=4)
    assert len(hist_t) == len(hist_j)
    assert _rel(th_t, th_j) <= 1e-8
    # the losses fall to the engines' rounding (~1e-17 dB^2): 1e-8 relative,
    # or 1e-20 dB^2 below that
    dh = np.abs(np.asarray(hist_t) - np.asarray(hist_j))
    assert np.all(dh <= np.maximum(1e-8 * np.abs(hist_j), 1e-20))


@pytest.mark.parametrize("call, exc, says", [
    (lambda c: TC.make_gain_model(c, p_in=P_IN, precision="df32", device="cpu"),
     ValueError, "df32"),
    (lambda c: TC.make_launch_gain_model(c, precision="df32", device="cpu"), ValueError, "df32"),
    (lambda c: TC.make_gain_model(c, p_in=[0.5, 0.5, 0.0, 0.0], device="cpu"), ValueError,
     "no input power"),
    (lambda c: TC.make_gain_model(c, p_in=P_IN, frame="lens", device="cpu"), ValueError,
     "frame must be"),
    (lambda c: TC.fit_gain_curve(c, delta_beta_grid=np.zeros(4), measured_gain_db=np.zeros(3),
                                 p_in=P_IN, device="cpu"), ValueError, "matching 1-D"),
    (lambda c: TC.fit_gain_curve(c, delta_beta_grid=np.zeros(4), measured_gain_db=np.zeros(4),
                                 p_in=P_IN, init=dict(bogus=1.0), device="cpu"), ValueError,
     "unknown init"),
    (lambda c: TC.fit_gain_curve(c, delta_beta_grid=np.zeros(4), measured_gain_db=np.zeros(4),
                                 p_in=P_IN, init=dict(gamma=-1.0), device="cpu"), ValueError,
     "positive"),
    (lambda c: TC.power_transfer_db_per_db(c, gamma=0.01, alpha=0.0, delta_beta=0.0,
                                           p_in=[0.5, 0.5, 0.0, 0.0], device="cpu"),
     ValueError, "no input power"),
    (lambda c: TC.phase_transfer_db_per_rad(c, gamma=0.01, alpha=0.0, delta_beta=0.0,
                                            p_in=[0.5, 0.5, 0.0, 0.0], device="cpu"),
     ValueError, "no input power"),
    (lambda c: TC.make_gain_model(T.custom_simulation_config(z_max=1.0, dz=0.5, save_every=10),
                                  p_in=P_IN, device="cpu"), ValueError, "no saved grid points"),
])
def test_validation_errors_carry_the_jax_messages(call, exc, says):
    _cj, ct = _cfgs()
    with pytest.raises(exc, match=says):
        call(ct)


def test_validation_messages_are_the_jax_packages():
    cj, ct = _cfgs()
    msgs = []
    for mod, c, kw in ((JC, cj, {}), (TC, ct, dict(device="cpu"))):
        with pytest.raises(ValueError) as e:
            mod.make_gain_model(c, p_in=P_IN, precision="df32", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    T0 = 1e-12
    grid_j = jgn.TimeGrid.for_pulse(T0, n_samples=128)
    grid_t = tgn.TimeGrid.for_pulse(T0, n_samples=128)
    A0 = np.asarray(J.sech_pulse(grid_j, peak_W=1.0, t0_s=T0))
    meas = np.zeros(128)
    for mod, c, g, kw in ((J, cj, grid_j, {}), (TC, ct, grid_t, dict(device="cpu"))):
        with pytest.raises(ValueError, match="positive 'gamma'"):
            mod.fit_pulse_spectrum(c, g, A0, meas, init=dict(beta2=-2e-26), **kw)
        with pytest.raises(ValueError, match="unknown init keys"):
            mod.fit_pulse_spectrum(c, g, A0, meas, init=dict(gamma=1e-3, kappa=1.0), **kw)
        with pytest.raises(ValueError, match=r"\(T,\) on the fft-ordered grid"):
            mod.fit_pulse_spectrum(c, g, A0, meas[:64], init=dict(gamma=1e-3), **kw)


def test_the_default_device_is_the_card():
    """``device=None`` is the CUDA card, as every entry point of the port;
    without one the model functions raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _cj, ct = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.make_gain_model(ct, p_in=P_IN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.power_transfer_db_per_db(ct, gamma=0.01, alpha=0.0, delta_beta=0.0, p_in=P_IN)
