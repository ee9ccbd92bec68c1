"""The port's multi-span amplified link (``parallel/link.py``) against the
JAX package's, on the CPU.

The Wigner launch ensemble and every amplifier's ASE are drawn by the same
``np.random.default_rng(seed)`` stream in both packages, so the port
(``device='cpu'``, one plain ``solve_gnlse_batch`` a span) is held to the
JAX package (x64) at the bars of ``test_torch_noise.py``: other floats
within 1e-9 relative, the moment statistics' means and covariance within
1e-9 of their ensemble spread, ``ok`` identical, ``elapsed_s`` skipped.
The JAX package's own oracles are run on the port: the noiseless
transparent chain is an identity (every statistic constant across spans
within 1e-9, the JAX test's bar), and ASE grows the frequency variance
where the control keeps it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_tpu as J  # noqa: E402
import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import link as JL  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import link as TL  # noqa: E402
from test_torch_noise import compare  # noqa: E402

torch.set_num_threads(1)

OM0, T0, BETA2 = 1.2e15, 1e-12, -2.0e-26


def setup(P, gamma=2e-3, beta2=BETA2, alpha=5e-3, spectral=False, n=128, z=50.0, steps=20,
          save_every=None):
    grid = P.gnlse.TimeGrid.for_pulse(T0, n_samples=n)
    disp = None if beta2 is None else P.DispersionParams.from_betas(OM0, beta2=beta2)
    if spectral:
        co = P.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma,
                                 alpha_spec_1_m=np.full(n, alpha))
    else:
        co = P.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma, alpha_1_m=alpha)
    A0 = np.asarray(P.sech_pulse(grid, peak_W=1.0, t0_s=T0))
    cfg = P.custom_simulation_config(z_max=z, dz=z / steps, save_every=save_every or steps)
    return grid, co, A0, cfg


def both(setup_kw=None, **kw):
    gj, cj, Aj, fj = setup(J, **(setup_kw or {}))
    gt, ct, At, ft = setup(T, **(setup_kw or {}))
    return (JL.pulse_link_monte_carlo(fj, cj, Aj, gj, omega0=OM0, **kw),
            TL.pulse_link_monte_carlo(ft, ct, At, gt, omega0=OM0, device="cpu", **kw))


@pytest.mark.parametrize("case", ["ase", "control", "n_sp-2", "amp-gain", "spectral-loss"])
def test_link_matches_jax(case):
    kw = dict(n_spans=3, n_samples=32, seed=3)
    setup_kw = None
    if case == "control":
        kw.update(ase=False)
    elif case == "n_sp-2":
        kw.update(n_sp=2.0)
    elif case == "amp-gain":
        kw.update(amp_gain=1.5)
    elif case == "spectral-loss":
        setup_kw = dict(spectral=True)
        kw.update(amp_gain=float(np.exp(5e-3 * 50.0)))
    rj, rt = both(setup_kw, **kw)
    compare(rt, rj)
    assert rt.z_m.shape == (4,) and rt.ok_fraction == 1.0


def test_noiseless_transparent_chain_is_identity():
    """gamma = 0, beta2 = 0, the loss restored exactly, ase=False: every
    lane comes back to itself each span (the JAX test's oracle)."""
    grid, co, A0, cfg = setup(T, gamma=0.0, beta2=None)
    m = TL.pulse_link_monte_carlo(cfg, co, A0, grid, omega0=OM0, n_spans=4, ase=False,
                                  n_samples=64, seed=0, device="cpu")
    assert m.ok_fraction == 1.0
    for arr in (m.energy_mean, m.energy_var, m.t_var, m.f_var, m.tf_cov):
        np.testing.assert_allclose(arr, arr[0], rtol=1e-9)


def test_ase_grows_the_frequency_variance_where_the_control_keeps_it():
    grid, co, A0, cfg = setup(T)
    kw = dict(omega0=OM0, n_spans=6, n_samples=64, seed=1, device="cpu")
    ms = TL.pulse_link_monte_carlo(cfg, co, A0, grid, **kw)
    mc = TL.pulse_link_monte_carlo(cfg, co, A0, grid, ase=False, **kw)
    assert ms.f_var[-1] / ms.f_var[0] > 2.0 * mc.f_var[-1] / mc.f_var[0]


@pytest.mark.parametrize("save_every", [20, 6, 7])
def test_span_observed_length_matches_jax(save_every):
    kw = dict(z_max=50.0, dz=2.5, save_every=save_every)
    assert TL.span_observed_length_m(T.custom_simulation_config(**kw)) == \
        JL.span_observed_length_m(J.custom_simulation_config(**kw))


VALIDATION = {
    "n-spans": (dict(gamma=0.0), dict(n_spans=0), "n_spans"),
    "n-sp": (dict(gamma=0.0), dict(n_spans=2, n_sp=0.5), "n_sp"),
    "amp-gain": (dict(gamma=0.0), dict(n_spans=2, amp_gain=0.5), "amp_gain"),
    "spectral-loss": (dict(gamma=0.0, spectral=True, alpha=1e-3), dict(n_spans=2),
                      "flat scalar"),
    "n-samples": (dict(gamma=0.0), dict(n_spans=2, n_samples=8), "n_samples"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_matches_jax(case):
    setup_kw, kw, match = VALIDATION[case]
    kw = dict(dict(n_samples=64), **kw)
    gj, cj, Aj, fj = setup(J, **setup_kw)
    gt, ct, At, ft = setup(T, **setup_kw)
    with pytest.raises(ValueError, match=match) as ej:
        JL.pulse_link_monte_carlo(fj, cj, Aj, gj, omega0=OM0, **kw)
    with pytest.raises(ValueError, match=match) as et:
        TL.pulse_link_monte_carlo(ft, ct, At, gt, omega0=OM0, device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_span_without_a_saved_point_raises_as_in_jax():
    kw = dict(z_max=50.0, dz=2.5, save_every=40)
    with pytest.raises(ValueError, match="no saved grid points") as ej:
        JL.span_observed_length_m(J.custom_simulation_config(**kw))
    with pytest.raises(ValueError, match="no saved grid points") as et:
        TL.span_observed_length_m(T.custom_simulation_config(**kw))
    assert str(et.value) == str(ej.value)


def test_sharded_ensemble_is_the_unsharded_one():
    """A mesh of 3 CPU slots splits each span's solve (17 lanes padded to
    18); the ASE draws stay on the host, in the same order, so the link's
    statistics are the unsharded ones, at the bars of the comparison with
    the JAX package."""
    grid, co, A0, cfg = setup(T)
    kw = dict(omega0=OM0, n_spans=2, n_samples=16, seed=0)
    plain = TL.pulse_link_monte_carlo(cfg, co, A0, grid, device="cpu", **kw)
    sharded = TL.pulse_link_monte_carlo(cfg, co, A0, grid,
                                        mesh=T.mesh_utils.default_mesh(3, device="cpu"), **kw)
    compare(sharded, plain)
    assert sharded.ok_fraction == 1.0


def test_mesh_is_refused():
    grid, co, A0, cfg = setup(T)
    with pytest.raises(TypeError, match="mesh must be"):
        TL.pulse_link_monte_carlo(cfg, co, A0, grid, omega0=OM0, n_spans=2, n_samples=16,
                                  mesh=object(), device="cpu")
