"""``parallel/calibrate`` against the JAX package on the CPU: the pulse
model and its spectrum fit (plain torch autograd through the GNLSE
stepper in both packages' sense: no kernel has a backward), and the
launch-power and launch-phase transfers (the tangent RK4 along the 8
launch directions).  Bars: the field 1e-12 of its peak and bit for bit
against the port's batched solver, the gradient 1e-8, ten-step fit
histories 1e-9, the transfers 1e-10 of their largest value."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import gnlse as jgn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tgn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import calibrate as TC  # noqa: E402
from test_torch_calibrate import _cfgs, _rel, _t  # noqa: E402


def _pulse_setup(n_per_period=40):
    """The JAX test's N = 1.5 soliton of 1 ps on 128 samples over half a
    soliton period, in ``n_per_period`` Strang steps saved in two chunks."""
    T0 = 1e-12
    grid_j = jgn.TimeGrid.for_pulse(T0, n_samples=128)
    grid_t = tgn.TimeGrid.for_pulse(T0, n_samples=128)
    truth = dict(gamma=2e-3, beta2=-2e-26)
    P0 = J.soliton_peak_power(truth["beta2"], truth["gamma"], T0) * 2.25
    A0 = np.asarray(J.sech_pulse(grid_j, peak_W=P0, t0_s=T0))
    zs = 0.5 * np.pi * T0 ** 2 / abs(truth["beta2"])
    cj, ct = _cfgs(z_max=zs, dz=zs / n_per_period, save_every=n_per_period // 2)
    return grid_j, grid_t, truth, A0, cj, ct


def test_pulse_model_matches_jax_and_the_batched_solver():
    """The field against JAX ``make_pulse_model`` (1e-12 of its peak) and,
    bit for bit, against the port's ``solve_gnlse_batch`` on the CPU (the
    same stepper, chunk for chunk, as the JAX test asserts of its own);
    the gradient in beta2 and gamma against ``jax.grad`` (1e-8)."""
    grid_j, grid_t, truth, A0, cj, ct = _pulse_setup()
    fj = J.make_pulse_model(cj, grid_j, A0)
    ft = TC.make_pulse_model(ct, grid_t, A0, device="cpu")
    yj = np.asarray(jax.jit(fj)(truth))
    with torch.no_grad():
        yt = ft(truth).numpy()
    assert np.max(np.abs(yt - yj)) <= 1e-12 * np.max(np.abs(yj))
    co = tgn.make_gnlse_coeffs(grid_t, T.DispersionParams.from_betas(1.2e15, beta2=truth["beta2"]),
                               gamma_W_m=truth["gamma"])
    _, A_ref, _ = T.solve_gnlse_batch(ct, co, A0[None], device="cpu")
    np.testing.assert_array_equal(yt, A_ref[0])

    def pj(x):
        return jnp.abs(fj({"gamma": x[0], "beta2": x[1]})[0]) ** 2

    x0 = np.array([truth["gamma"], truth["beta2"]])
    gj = np.asarray(jax.grad(pj)(jnp.asarray(x0)))
    x = _t(x0, requires_grad=True)
    (gt,) = torch.autograd.grad(ft({"gamma": x[0], "beta2": x[1]})[0].abs() ** 2, x)
    assert _rel(gt.numpy(), gj) <= 1e-8
    with pytest.raises(ValueError, match="unknown theta key"):
        ft({"gamma": 1e-3, "kappa": 1.0})
    with pytest.raises(ValueError, match="samples but the grid has"):
        TC.make_pulse_model(ct, grid_t, A0[:64], device="cpu")


def test_pulse_spectrum_fit_matches_jax():
    grid_j, grid_t, truth, A0, cj, ct = _pulse_setup()
    y = np.asarray(jax.jit(J.make_pulse_model(cj, grid_j, A0))(truth))
    meas = 10 * np.log10(np.maximum(np.abs(np.fft.fft(y)) ** 2, 1e-300))
    kw = dict(init=dict(gamma=1.4e-3, beta2=-2.8e-26), steps=10, learning_rate=0.1)
    rj = J.fit_pulse_spectrum(cj, grid_j, A0, meas, **kw)
    rt = TC.fit_pulse_spectrum(ct, grid_t, A0, meas, **kw, device="cpu")
    assert rt.n_steps == rj.n_steps == 10
    assert _rel(rt.loss_history, rj.loss_history) <= 1e-9
    for k in truth:
        assert _rel(rt.params[k], rj.params[k]) <= 1e-9, k
    assert np.max(np.abs(rt.gain_db - rj.gain_db)) <= 1e-9


@pytest.mark.parametrize("what", ["power", "phase"])
def test_transfers_match_jax(what):
    """The launch-power and launch-phase transfers (one gradient through
    the 8 launch directions) for a PIA and a PSA seed, with the JAX test's
    gauge structure: a PIA's phase transfers vanish, the PSA's are (-, -,
    +, +) of one magnitude summing to 0."""
    cj, ct = _cfgs(dz=0.5, save_every=20)
    fn = f"{what}_transfer_db_per_{'db' if what == 'power' else 'rad'}"
    kw = dict(gamma=0.0115, alpha=2e-4, delta_beta=-3e-3)
    for p_in, phase_in in (([0.5, 0.5, 1e-5, 0.0], None),
                           ([0.5, 0.5, 5e-6, 5e-6], [0.0, 0.0, 0.8, 0.0])):
        a = getattr(J, fn)(cj, **kw, p_in=p_in, phase_in=phase_in)
        b = getattr(TC, fn)(ct, **kw, p_in=p_in, phase_in=phase_in, device="cpu")
        if what == "phase" and phase_in is None:
            assert np.all(np.abs(b) < 1e-9) and np.all(np.abs(a) < 1e-9)
            continue
        assert np.max(np.abs(b - a)) <= 1e-10 * np.max(np.abs(a))
    if what == "phase":
        assert abs(b.sum()) < 1e-9 and b[2] > 0.1
        np.testing.assert_allclose(b[2], b[3], rtol=1e-9)
        np.testing.assert_allclose(b[0], b[1], rtol=1e-9)
        np.testing.assert_allclose(b[0], -b[2], rtol=1e-9)
    else:
        assert b[0] > 0.5 and b[3] > 0.0
    gl = TC.make_launch_gain_model(ct, device="cpu")
    pv = _t([0.5, 0.5, 1e-5, 0.0], requires_grad=True)
    v = gl(pv, _t(np.zeros(4)), T.RHSCoeffs(0.0115, 2e-4, -3e-3))
    assert v.shape == () and bool(torch.isfinite(v))
