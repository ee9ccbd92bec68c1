"""The port's supercontinuum experiments against the JAX package's on the
CPU, at the size of the JAX tests (``tests/test_gnlse.py::
test_supercontinuum_soliton_fission``, ``tests/test_vgnlse_nl.py``): the
results and the saved archives within 1e-10 of each result's largest value
(step-doubling rk45, the class of the port's other rk45 tests), the same
file names, and the JAX tests' physics bars on the port's result.  Apart
from ``test_torch_experiments.py`` (whose helpers it uses) for its time:
each run is ~10 s of plain torch on one CPU core."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models.gnlse import TimeGrid  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models.vgnlse import (  # noqa: E402
    degree_of_polarization,
)
from test_torch_experiments import _check_results, _check_saved, _run  # noqa: E402

torch.set_num_threads(1)


def _bw(a):
    S = np.abs(np.fft.fft(a)) ** 2
    idx = np.nonzero(np.fft.fftshift(S > S.max() * 1e-3))[0]
    return idx[-1] - idx[0]


def test_supercontinuum_matches_jax_and_fissions(tmp_path):
    """The scaled-down Dudley run of the JAX test: an N~9 soliton fissions
    (-30 dB bandwidth x5) with bounded Raman drain."""
    kw = dict(n_samples=1024, window_ps=3.0, length_m=0.03, rtol=1e-5, n_saved=20)
    rj, rt, dj, dt = _run("supercontinuum", tmp_path, **kw)
    _check_results(rt, rj, normwise=1e-10)
    _check_saved(dt, dj, normwise=1e-10)
    z, A = rt
    assert np.all(np.isfinite(A)) and _bw(A[-1]) > 5 * _bw(A[0])
    E = (np.abs(A) ** 2).sum(axis=-1) * (3.0e-12 / 1024)
    assert 0.7 < E[-1] / E[0] <= 1.0 + 1e-9


def test_vector_supercontinuum_matches_jax_and_keeps_polarization(tmp_path):
    kw = dict(n_samples=1024, window_ps=3.0, length_m=0.03, theta_deg=25.0, rtol=1e-5,
              n_saved=10)
    rj, rt, dj, dt = _run("vector_supercontinuum", tmp_path, **kw)
    _check_results(rt, rj, normwise=1e-10)
    _check_saved(dt, dj, normwise=1e-10)
    z, A = rt
    assert np.all(np.isfinite(A))
    for p in (0, 1):
        assert _bw(A[-1][p]) > 5 * _bw(A[0][p])
    assert degree_of_polarization(TimeGrid(n_samples=1024, t_window_s=3.0e-12), A[-1]) > 0.9999
