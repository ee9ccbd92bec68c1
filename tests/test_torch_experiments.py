"""The port's experiments (``experiments/``) against the JAX package's, on
the CPU: each runs at a small size with ``show=False`` and a save directory,
beside its JAX counterpart with the same arguments.  The returned arrays and
the arrays of every saved ``.npz`` (all keys but the metadata) must agree,
and both packages must write the same files.

Tolerances (float64; the packages round their transforms and products
differently, and the differences grow over the steps):

- the 4-wave sweeps and the single run: 1e-12 relative, element by element;
- the fixed-step trajectories of the comb, Kerr-cavity, pulse and SBS
  experiments: 1e-12 of each result's largest value (normwise);
- the adaptive ones (the comb's default rk45): 1e-10 normwise, the class
  of the port's other rk45 tests (``supercontinuum`` and
  ``vector_supercontinuum`` are in ``test_torch_supercontinuum.py``);
- the 45.292 dB anchor within 2e-3 (``tests/test_io_plotting.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psa_simulation_ode_rk_mvp_dispersion_tpu import experiments as JE  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import experiments as TE  # noqa: E402

torch.set_num_threads(1)


def _run(name, tmp_path, *, jax_saves=True, **kw):
    """Run the experiment ``name`` in both packages, each into a directory
    of its own; return (JAX result, port result, JAX dir, port dir)."""
    quiet = {} if name == "gain_map" else {"verbose": False}
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()   # the JAX gain_map saves only its figure and makes no directory
    rj = getattr(JE, name)(show=False, save_dir=str(dj) if jax_saves else None, **quiet, **kw)
    rt = getattr(TE, name)(show=False, save_dir=str(dt), device="cpu", **quiet, **kw)
    return rj, rt, dj, dt


def _arrays(res):
    """The arrays of a result: a sweep's fields, or the items of a tuple."""
    if dataclasses.is_dataclass(res):
        return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
                if isinstance(getattr(res, f.name), np.ndarray)}
    if isinstance(res, tuple):
        out = {}
        for i, r in enumerate(res):
            sub = _arrays(r)
            out.update({f"{i}.{k}": v for k, v in sub.items()} if isinstance(sub, dict)
                       else {str(i): sub})
        return out
    return np.asarray(res)


def _normwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _check(got, ref, *, normwise=None):
    """Elementwise 1e-12 relative (NaN where the reference has NaN), or
    within ``normwise`` of the largest reference value."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if got.dtype == bool or got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, ref)
    elif normwise is None:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0, equal_nan=True)
    else:
        assert _normwise(got, ref) <= normwise


def _check_results(rt, rj, **kw):
    at, aj = _arrays(rt), _arrays(rj)
    if isinstance(aj, dict):
        assert at.keys() == aj.keys()
        for k in aj:
            _check(at[k], aj[k], **kw)
    else:
        _check(at, aj, **kw)


def _check_saved(dt, dj, **kw):
    """Both packages wrote the same files, and each .npz holds the same
    arrays under the same keys (the metadata aside)."""
    assert sorted(p.name for p in dt.iterdir()) == sorted(p.name for p in dj.iterdir())
    for pj in sorted(dj.glob("*.npz")):
        with np.load(pj) as zj, np.load(dt / pj.name) as zt:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                if k != "metadata_json":
                    _check(zt[k], zj[k], **kw)


def test_single_simulation_anchor_and_parity(tmp_path, capsys):
    """The reference's main_single_simulation at its defaults: the 45.292 dB
    anchor, the printed plan and result, the run bundle."""
    rj, rt, dj, dt = _run("single_simulation", tmp_path)
    capsys.readouterr()
    z, A = TE.single_simulation(show=False, verbose=True, device="cpu", z_max_m=1.0)
    out = capsys.readouterr().out
    assert "Frequency plan" in out and "Signal gain" in out
    gain_db = 10 * np.log10(np.abs(rt[1][-1, 2]) ** 2 / 1e-5)
    assert gain_db == pytest.approx(45.292, abs=2e-3)
    _check_results(rt, rj)
    _check_saved(dt, dj)
    assert sorted(p.name for p in dt.iterdir()) == [
        "single_simulation.csv", "single_simulation.json", "single_simulation.npz",
        "single_simulation.png"]


@pytest.mark.parametrize("name, kw, files", [
    ("gain_spectrum", dict(n_points=6, z_max_m=50.0), ["gain_spectrum.npz", "gain_spectrum.png"]),
    ("gain_spectrum_dbeta", dict(n_points=8, z_max_m=100.0),
     ["gain_spectrum_dbeta.npz", "gain_spectrum_dbeta.png"]),
    ("mismatch_scan", dict(n_points=16, span=30.0, z_max_km=0.2),
     ["mismatch_best_powers.png", "mismatch_best_si.png", "mismatch_scan.npz",
      "mismatch_scan.png"]),
    ("psa_phase_sweep", dict(n_points=9), ["psa_phase_sweep.npz", "psa_phase_sweep.png"]),
    ("gain_map", dict(n_wavelengths=5, z_max_m=50.0), ["gain_map.png"]),
])
def test_four_wave_sweep_experiments_match_jax(tmp_path, name, kw, files):
    rj, rt, dj, dt = _run(name, tmp_path, **kw)
    _check_results(rt, rj)
    _check_saved(dt, dj)
    assert sorted(p.name for p in dt.iterdir()) == files


def test_sweep_experiments_take_the_integrator_and_precision(tmp_path):
    """rk45 through the adaptive sweep and x32 at float32, as the CLI's
    --integrator and --precision pass them."""
    kw = dict(n_points=6, z_max_m=20.0, show=False, verbose=False)
    r45 = TE.gain_spectrum(integrator="rk45", device="cpu", **kw)
    j45 = JE.gain_spectrum(integrator="rk45", **kw)
    np.testing.assert_allclose(r45.gain, j45.gain, rtol=1e-10)
    r32 = TE.gain_spectrum(precision="x32", device="cpu", **kw)
    r64 = TE.gain_spectrum(device="cpu", **kw)
    np.testing.assert_allclose(10 ** (r32.gain / 10), 10 ** (r64.gain / 10), rtol=1e-4)


@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_comb_matches_jax_and_writes_its_bundle(tmp_path, integrator):
    """The JAX experiment cannot save a comb of other than 4 lines (its CSV
    takes the 4-wave labels), so it runs without a directory here."""
    rj, rt, _dj, dt = _run("comb", tmp_path, jax_saves=False, n_lines=16, z_max_m=2.0,
                           integrator=integrator)
    _check_results(rt, rj, normwise=1e-12 if integrator == "rk4" else 1e-10)
    assert sorted(p.name for p in dt.iterdir()) == ["comb.csv", "comb.json", "comb.npz",
                                                     "comb.png"]
    with np.load(dt / "comb.npz") as z:
        np.testing.assert_array_equal(z["A"], rt[1])
    header = (dt / "comb.csv").read_text().splitlines()[0].split(",")
    assert len(header) == 1 + 2 * 16


@pytest.mark.parametrize("name, kw, bar", [
    ("kerr_cavity", dict(n_samples=128, lifetimes=3.0, hold_lifetimes=1.0), 1e-12),
    ("gnlse_pulse", dict(n_soliton=1.0, n_periods=0.25, n_steps=500, n_samples=256), 1e-12),
    ("gnlse_pulse", dict(n_periods=0.25, n_steps=200, n_samples=256, raman=True,
                         steepening=True), 1e-12),
    ("vector_pulse", dict(n_periods=0.25, n_steps=200, n_samples=256), 1e-12),
    ("vector_pulse", dict(n_periods=0.25, n_steps=200, n_samples=256, coupling="cnlse",
                          raman=True), 1e-12),
    ("fwm_sbs", dict(z_max_m=5.0), 1e-12),
])
def test_family_experiments_match_jax(tmp_path, name, kw, bar):
    rj, rt, dj, dt = _run(name, tmp_path, **kw)
    if name == "fwm_sbs":
        assert rt.n_iterations == rj.n_iterations
        for f in ("z", "A", "B", "reflectivity"):
            _check(getattr(rt, f), getattr(rj, f), normwise=bar)
    else:
        _check_results(rt, rj, normwise=bar)
    _check_saved(dt, dj, normwise=bar)


def test_what_waits_for_a_later_slice_raises():
    """A mesh that is not the port's (``parallel/mesh.Mesh``) raises a
    TypeError, in the Monte-Carlo experiments too; nothing is skipped
    silently.  The Monte-Carlo
    experiments (item 15) and the calibration experiment ``fit_gain``
    (item 16) are exported with the JAX package's names."""
    with pytest.raises(TypeError, match="mesh must be"):
        TE.supercontinuum(mesh=object(), n_samples=256, show=False, device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        TE.gain_spectrum(n_points=2, mesh=object(), show=False, verbose=False, device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        TE.squeezing(n_samples=16, z_max_m=1.0, mesh=object(), show=False, verbose=False,
                     device="cpu")
    assert hasattr(TE, "fit_gain") and "fit_gain" in TE.__all__
    assert set(JE.__all__) <= set(TE.__all__)


def test_without_matplotlib_the_data_files_are_still_written(tmp_path, monkeypatch, capsys):
    """A machine without matplotlib: the figures are not drawn, stderr names
    each one, and the data files are written as with it."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    res = TE.gain_spectrum(n_points=3, z_max_m=5.0, show=False, verbose=False,
                           save_dir=str(tmp_path), device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["gain_spectrum.npz"]
    assert f"{tmp_path}/gain_spectrum.png is not written" in capsys.readouterr().err
    assert res.gain.shape == (3,)
