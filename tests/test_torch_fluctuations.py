"""The port's gain-ripple Monte Carlo (``parallel/fluctuations.py``) against
the JAX package's, on the CPU.

The port composes one batched solve a segment on the host everywhere; the
JAX package has that path (its ``engine='scan'``) and a fused one (its
``engine='auto'``: the segments under one ``lax.scan``, lab frame), which
its own test holds to the host path at 1e-9 dB
(``tests/test_fluctuations.py::test_fused_matches_host_composed_path``).
The realizations are drawn by ``np.random.default_rng(seed)`` in both, so
the same seed gives the same fibers.  Bars:

- against the JAX fused path: every gain within 1e-9 dB, ``ok`` identical;
- against the JAX host-composed path: every gain within 1e-12 relative in
  linear gain, ``ok`` identical;
- the other fields of the result as in ``test_torch_noise.py`` (gains
  1e-9 dB, other floats 1e-9 relative, ``elapsed_s`` skipped);
- the zero-sigma composition oracle: the segmented nominal lane equals one
  continuous ``solve_batch`` within 1e-10 dB (the JAX test's bar).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import fluctuations as JF  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import (  # noqa: E402
    fluctuations as TF,
)
from test_torch_noise import cfgs, compare  # noqa: E402

import psa_torch as T  # noqa: E402

torch.set_num_threads(1)

GAMMA, P_IN = 5e-3, [0.5, 0.5, 1e-6, 0.0]
DB_OPT = -5e-3  # kappa = 0 for gamma (P1+P2) = 5e-3


def _lin(g_db):
    return 10.0 ** (np.asarray(g_db) / 10.0)


@pytest.mark.parametrize("alpha, sigma, seed", [(1e-4, 0.02, 5), (0.0, 0.05, 2)])
def test_gain_ripple_matches_both_jax_paths(alpha, sigma, seed):
    cj, ct = cfgs(z_max=40.0, dz=0.05, save_every=50)
    kw = dict(gamma=GAMMA, alpha=alpha, p_in=P_IN, delta_beta_mean=DB_OPT, sigma_dbeta=sigma,
              n_segments=8, n_realizations=64, seed=seed)
    rt = TF.gain_ripple_monte_carlo(ct, device="cpu", **kw)
    fused = JF.gain_ripple_monte_carlo(cj, engine="auto", **kw)
    host = JF.gain_ripple_monte_carlo(cj, engine="scan", **kw)
    compare(rt, fused)
    np.testing.assert_array_equal(rt.ok, host.ok)
    np.testing.assert_allclose(_lin(rt.gain_db), _lin(host.gain_db), rtol=1e-12, atol=0)
    np.testing.assert_allclose(_lin(rt.gain_nominal_db), _lin(host.gain_nominal_db),
                               rtol=1e-12, atol=0)
    assert rt.ok.all() and rt.gain_std_db > 0


def test_zero_sigma_segmented_equals_continuous():
    """8 composed segments with the phase-rotation bookkeeping == one
    continuous solve (pins the Phi_s algebra in the port)."""
    _, ct = cfgs(z_max=40.0, dz=0.05, save_every=50)
    db0 = 0.05
    r = TF.gain_ripple_monte_carlo(ct, gamma=GAMMA, alpha=1e-4, p_in=P_IN, delta_beta_mean=db0,
                                   sigma_dbeta=0.0, n_segments=8, n_realizations=4, seed=1,
                                   device="cpu")
    A0 = np.asarray(T.make_initial_amplitudes(P_IN, np.zeros(4)))[None]
    rc = T.solve_batch(ct, T.RHSCoeffs(gamma=np.full(1, GAMMA), alpha=np.full(1, 1e-4),
                                       delta_beta=np.full(1, db0)), A0, device="cpu")
    g_cont = 10 * np.log10(np.abs(rc.A_end[0, 2]) ** 2 / P_IN[2])
    assert r.gain_nominal_db == pytest.approx(g_cont, abs=1e-10)
    np.testing.assert_allclose(r.gain_db, r.gain_nominal_db, atol=1e-9)


def test_percentile_ci_matches_jax():
    x = np.random.default_rng(3).standard_normal(501)
    for q in (5, 50, 95):
        assert TF._percentile_ci(x, q) == JF._percentile_ci(x, q)


def _cfg_kw(**kw):
    base = dict(z_max=40.0, dz=0.05, save_every=50)
    base.update(kw)
    return base


@pytest.mark.parametrize("case", ["no-signal", "segments", "save-every", "one-realization"])
def test_validation_matches_jax(case):
    kw = dict(gamma=GAMMA, alpha=0.0, delta_beta_mean=0.0, sigma_dbeta=0.01, p_in=P_IN,
              n_segments=8)
    cfg_kw = _cfg_kw()
    if case == "no-signal":
        kw.update(p_in=[0.5, 0.5, 0.0, 0.0], n_segments=4)
        match = "signal needs nonzero"
    elif case == "segments":
        kw.update(n_segments=7)
        match = "whole segments"
    elif case == "save-every":
        cfg_kw = _cfg_kw(save_every=300)
        match = "save_every"
    else:
        kw.update(n_realizations=1)
        match = "n_realizations"
    cj, ct = cfgs(**cfg_kw)
    with pytest.raises(ValueError, match=match) as ej:
        JF.gain_ripple_monte_carlo(cj, **kw)
    with pytest.raises(ValueError, match=match) as et:
        TF.gain_ripple_monte_carlo(ct, device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_sharded_ensemble_is_the_unsharded_one():
    """A mesh of 3 CPU slots splits each segment's solve (7 lanes padded to
    9); the draws stay on the host, in the same order, so the ensemble is
    the unsharded one, at the bars of the comparison with the JAX package."""
    _, ct = cfgs(**_cfg_kw())
    kw = dict(gamma=GAMMA, alpha=1e-4, p_in=P_IN, delta_beta_mean=0.05, sigma_dbeta=0.01,
              n_segments=8, n_realizations=7, seed=2)
    plain = TF.gain_ripple_monte_carlo(ct, device="cpu", **kw)
    sharded = TF.gain_ripple_monte_carlo(ct, mesh=T.mesh_utils.default_mesh(3, device="cpu"),
                                         **kw)
    compare(sharded, plain)
    assert sharded.gain_db.shape == plain.gain_db.shape


def test_mesh_is_refused():
    _, ct = cfgs(**_cfg_kw())
    with pytest.raises(TypeError, match="mesh must be"):
        TF.gain_ripple_monte_carlo(ct, gamma=GAMMA, alpha=0.0, p_in=P_IN, delta_beta_mean=0.0,
                                   sigma_dbeta=0.01, n_segments=8, n_realizations=4,
                                   mesh=object(), device="cpu")


def test_df32_request_runs_one_solve_a_segment_at_df32(monkeypatch):
    """The port of the JAX package's df32-routing test: a df32 request runs
    the host-composed path, one ``solve_batch`` a segment at the requested
    precision and engine (the port has no fused path to fall into; on the
    card each of these is one ``csrc/fwm4_rk.cu`` launch in fp64)."""
    calls = []

    def fake_solve_batch(cfg, coeffs, A, mesh=None, engine="auto", device=None):
        calls.append((cfg.precision, engine, mesh, device))
        A = np.asarray(A) * 0.9
        return type("R", (), {"ok": np.ones(A.shape[0], dtype=bool), "A_end": A,
                              "P_end": np.abs(A) ** 2})()

    monkeypatch.setattr(TF, "solve_batch", fake_solve_batch)
    cfg = dataclasses.replace(T.custom_simulation_config(z_max=10.0, dz=0.1, save_every=10),
                              precision="df32")
    res = TF.gain_ripple_monte_carlo(
        cfg, gamma=0.01, alpha=0.0, p_in=[0.1, 0.1, 1e-4, 0.0], delta_beta_mean=0.0,
        sigma_dbeta=0.01, n_segments=2, n_realizations=4, seed=0, device="cpu")
    assert calls == [("df32", "auto", None, "cpu")] * 2
    assert np.isfinite(res.gain_mean_db)
