"""The Monte-Carlo subcommands of the port's command line on the CPU
(``--device cpu``), against the JAX package's command line with the same
arguments: each run writes the JAX file names, and each ``.npz`` holds
the JAX arrays under the same keys, at the bars of ``test_torch_noise.py``
(gains within 1e-9 dB, other dB figures within 1e-6 dB, other floats
within 1e-9 relative, ``ok`` and counts identical; the jitter and link
covariances within 1e-9 of their ensemble spread; a coherence |g12| and a
mean photon number within 1e-9 of their largest value, since the incoherent
bins are differences of near-equal sums).  The sizes are cut with the
subcommands' own flags (ensembles of 16-32, short fibres); the flags the
subcommands do not take keep their defaults.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psa_simulation_ode_rk_mvp_dispersion_tpu import __main__ as jcli  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import __main__ as cli  # noqa: E402
from test_torch_noise import compare  # noqa: E402

torch.set_num_threads(1)

SPREAD = {"tf_cov": ("t_var", "f_var"), "tf_cov_loss": ("t_var_loss", "f_var_loss")}
NORMWISE = ("g12", "mean_photons", "photon_n_mean")

# (argv after the global options, the data files the run writes)
RUNS = {
    "noise-figure": (["noise-figure", "--samples", "32", "--z-max", "20", "--phase-points", "3",
                      "--spectrum-points", "3"],
                     ["noise_figure.npz", "noise_figure_spectrum.npz"]),
    "noise-figure-langevin": (["noise-figure", "--samples", "32", "--z-max", "20",
                               "--phase-points", "2", "--alpha-db-km", "20", "--loss-model",
                               "langevin", "--loss-segments", "4"], ["noise_figure.npz"]),
    "gain-ripple": (["gain-ripple", "--realizations", "16", "--segments", "20"],
                    ["gain_ripple.npz"]),
    "squeezing": (["squeezing", "--samples", "32", "--z-max", "20"], ["squeezing.npz"]),
    "soliton-squeezing": (["soliton-squeezing", "--samples", "16", "--periods", "0.5",
                           "--points", "2"], ["soliton_squeezing.npz"]),
    "jitter": (["jitter", "--samples", "16", "--periods", "0.5", "--points", "2"],
               ["soliton_jitter.npz"]),
    "link": (["link", "--samples", "16", "--spans", "2"], ["soliton_link.npz"]),
    "mi-noise": (["mi-noise", "--samples", "16", "--nonlinear-lengths", "0.5"],
                 ["mi_noise.npz"]),
    "supercontinuum-coherence": (["supercontinuum", "--samples", "512", "--length", "0.005",
                                  "--rtol", "1e-5", "--coherence", "16"],
                                 ["supercontinuum.npz", "supercontinuum_coherence.npz"]),
}


def _npz_equal(pt, pj):
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zt.files) == sorted(zj.files), pj.name
        for k in zj.files:
            if k == "metadata_json":
                continue
            if k in SPREAD:
                scale = np.prod([np.sqrt(np.max(zj[v])) for v in SPREAD[k]])
                np.testing.assert_allclose(zt[k], zj[k], rtol=0, atol=1e-9 * scale,
                                           err_msg=f"{pj.name}:{k}")
            elif k in NORMWISE:
                np.testing.assert_allclose(zt[k], zj[k], rtol=0,
                                           atol=1e-9 * np.max(np.abs(zj[k])),
                                           err_msg=f"{pj.name}:{k}")
            elif pj.name == "supercontinuum.npz":
                # the adaptive trajectory: the class of the port's other rk45 tests
                assert np.max(np.abs(zt[k] - zj[k])) <= 1e-10 * np.max(np.abs(zj[k])), k
            else:
                compare(zt[k], zj[k], f"{pj.name}.{k}")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_noise_subcommand_matches_jax(tmp_path, run, capsys):
    argv, data = RUNS[run]
    dj, dt = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["--no-show", "--quiet", "--save-dir", str(dj)] + argv) == 0
    assert cli.main(["--device", "cpu", "--no-show", "--quiet", "--save-dir", str(dt)]
                    + argv) == 0
    names = sorted(p.name for p in dj.iterdir())
    assert sorted(p.name for p in dt.iterdir()) == names
    assert set(data) <= set(names)
    for pj in sorted(dj.glob("*.npz")):
        _npz_equal(dt / pj.name, pj)


def test_noise_subcommands_refuse_the_integrator(capsys):
    """As in the JAX package: the Monte-Carlo subcommands take no
    --integrator."""
    for argv in (["noise-figure"], ["gain-ripple"], ["squeezing"], ["soliton-squeezing"],
                 ["jitter"], ["link"], ["mi-noise"]):
        with pytest.raises(SystemExit) as e:
            cli.main(["--integrator", "rk45"] + argv)
        assert e.value.code == 2
        assert f"not honored by '{argv[0]}'" in capsys.readouterr().err
