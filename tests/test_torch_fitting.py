"""The calibration experiment ``experiments.fit_gain`` and the ``fit-gain``
subcommand of the port on the CPU, against the JAX package's on the same
``mismatch_scan.npz`` archive (a small one: 0.1 km in steps of 5 m, the
defaults otherwise), and the JAX round-trip test's bars: a ``mismatch``
archive fitted back to its own gamma of 10 1/(W km) within 2%, the offset
under 0.5 1/km and the rms residual under 0.01 dB."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from psa_simulation_ode_rk_mvp_dispersion_tpu import experiments as JE  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import __main__ as cli  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import experiments as TE  # noqa: E402

SMALL = dict(z_max_km=0.1, dz_km=5e-3)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A ``mismatch`` archive written by the port: 16 points over +-30
    1/km, 20 RK4 steps."""
    d = tmp_path_factory.mktemp("sweep")
    TE.mismatch_scan(span=30, n_points=16, show=False, save_dir=str(d), verbose=False,
                     device="cpu", **SMALL)
    return d / "mismatch_scan.npz"


def test_fit_gain_matches_the_jax_experiment(archive, tmp_path):
    """Ten adam steps on the same archive through both packages: the same
    parameters and loss history (rel 1e-9) and the same files."""
    kw = dict(steps=10, show=False, verbose=False)
    fj = JE.fit_gain(str(archive), save_dir=str(tmp_path / "jax"), **kw)
    ft = TE.fit_gain(str(archive), save_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert ft.n_steps == fj.n_steps == 10
    np.testing.assert_allclose(ft.loss_history, fj.loss_history, rtol=1e-9)
    for k, v in fj.params.items():
        assert ft.params[k] == pytest.approx(v, rel=1e-9, abs=1e-15), k
    with np.load(tmp_path / "jax" / "fit_gain.npz") as zj, \
            np.load(tmp_path / "port" / "fit_gain.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        np.testing.assert_array_equal(zt["delta_beta_1_km"], zj["delta_beta_1_km"])
        np.testing.assert_array_equal(zt["measured_gain_db"], zj["measured_gain_db"])
        np.testing.assert_allclose(zt["model_gain_db"], zj["model_gain_db"], rtol=1e-9)


def test_fit_gain_round_trip_recovers_the_sweep(archive, tmp_path, capsys):
    """The JAX round-trip test's bars on the small archive (up to 400
    steps; the fit stops early below 1e-4 dB rms)."""
    fit = TE.fit_gain(str(archive), steps=400, show=False, save_dir=str(tmp_path),
                      verbose=True, device="cpu")
    assert "fitted over 16 points" in capsys.readouterr().out
    assert fit.params["gamma"] * 1e3 == pytest.approx(10.0, rel=0.02)
    assert abs(fit.params["dbeta_offset"] * 1e3) < 0.5
    assert np.sqrt(fit.loss_db2) < 0.01
    assert (tmp_path / "fit_gain.npz").exists()


def test_fit_gain_subcommand_on_the_cpu(archive, tmp_path, capsys):
    """``python -m ... --device cpu fit-gain <archive>``: exit 0, the
    printed fit and the JAX file names (the figure where matplotlib is)."""
    code = cli.main(["--device", "cpu", "--no-show", "--save-dir", str(tmp_path), "fit-gain",
                     str(archive), "--steps", "5", "--init-gamma", "9", "--lr", "0.02"])
    assert code == 0
    out = capsys.readouterr()
    assert "fitted over 16 points in 5 steps" in out.out
    with np.load(tmp_path / "fit_gain.npz") as z:
        assert z["loss_history"].shape == (6,) and z["model_gain_db"].shape == (16,)
    assert (tmp_path / "fit_gain.png").exists() or "fit_gain.png is not written" in out.err


def test_fit_gain_refuses_what_the_jax_experiment_refuses(tmp_path):
    np.savez(tmp_path / "bare.npz", x=np.zeros(5), gain=np.ones(5), ok=np.ones(5, np.int8))
    for mod, kw in ((JE, {}), (TE, dict(device="cpu"))):
        with pytest.raises(ValueError, match="carries no config metadata"):
            mod.fit_gain(str(tmp_path / "bare.npz"), steps=1, show=False, **kw)
    few = tmp_path / "few"
    TE.mismatch_scan(span=30, n_points=3, show=False, save_dir=str(few), verbose=False,
                     device="cpu", **SMALL)
    for mod, kw in ((JE, {}), (TE, dict(device="cpu"))):
        with pytest.raises(ValueError, match="fewer than 4 finite sweep points"):
            mod.fit_gain(str(few / "mismatch_scan.npz"), steps=1, show=False, **kw)
