"""The port's ``io_fwm`` against the JAX package's: archives written by one
package read the same in the other (trajectory NPZ, sweep, gain map, run
bundle with its CSV and JSON), in both directions.  Equality is exact: the
archives hold the arrays as written."""

import csv
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu import io_fwm as jio  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import sweep as jsw  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import io_fwm as tio  # noqa: E402

PAIRS = {"port_writes": (tio, jio), "jax_writes": (jio, tio)}


def _trajectory(seed=0):
    rng = np.random.default_rng(seed)
    z = np.linspace(0.0, 5.0, 7)
    A = rng.normal(size=(7, 4)) + 1j * rng.normal(size=(7, 4))
    return z, A


@pytest.mark.parametrize("direction", sorted(PAIRS))
def test_result_npz_round_trip(tmp_path, direction):
    writer, reader = PAIRS[direction]
    z, A = _trajectory()
    p = writer.save_result_npz(tmp_path / "run", z, A, metadata={"note": "x", "n": 3})
    assert p.suffix == ".npz"
    z2, A2, md = reader.load_result_npz(p)
    np.testing.assert_array_equal(z2, z)
    np.testing.assert_array_equal(A2, A)
    assert md["note"] == "x" and md["n"] == 3 and "timestamp_utc" in md
    with pytest.raises(FileExistsError):
        writer.save_result_npz(p, z, A)


def _sweeps(rng):
    x = np.linspace(1540.0, 1560.0, 5)
    gain = rng.normal(size=5)
    gain[2] = np.nan
    ok = np.array([True, True, False, True, True])
    port = T.SweepResult(x=x, gain=gain, dbeta=rng.normal(size=5), ok=ok, gain_unit="db",
                         elapsed_s=0.5, points_per_s=10.0)
    jax = jsw.SweepResult(x=x, gain=gain, dbeta=port.dbeta, ok=ok, gain_unit="db",
                          elapsed_s=0.5, points_per_s=10.0)
    return {tio: port, jio: jax}


@pytest.mark.parametrize("with_dbeta", [True, False])
@pytest.mark.parametrize("direction", sorted(PAIRS))
def test_sweep_npz_round_trip(tmp_path, direction, with_dbeta):
    writer, reader = PAIRS[direction]
    sweep = _sweeps(np.random.default_rng(1))[writer]
    if not with_dbeta:
        sweep = type(sweep)(**{**sweep.__dict__, "dbeta": None})
    p = writer.save_sweep_npz(tmp_path / "sweep.npz", sweep, metadata={"tag": direction})
    x, gain, dbeta, ok, md = reader.load_sweep_npz(p)
    np.testing.assert_array_equal(x, sweep.x)
    np.testing.assert_array_equal(gain, sweep.gain)
    np.testing.assert_array_equal(ok, sweep.ok)
    if with_dbeta:
        np.testing.assert_array_equal(dbeta, sweep.dbeta)
    else:
        assert dbeta is None
    assert md["gain_unit"] == "db" and md["points_per_s"] == 10.0 and md["tag"] == direction


@pytest.mark.parametrize("direction", sorted(PAIRS))
def test_gain_map_npz_round_trip(tmp_path, direction):
    writer, reader = PAIRS[direction]
    rng = np.random.default_rng(2)
    fields = dict(x=np.linspace(1540.0, 1560.0, 4), pump_powers=np.array([0.1, 0.2, 0.4]),
                  gain=rng.normal(size=(3, 4)), ok=rng.uniform(size=(3, 4)) > 0.2,
                  gain_unit="linear", elapsed_s=1.5, points_per_s=8.0)
    gm = (T.GainMapResult if writer is tio else jsw.GainMapResult)(**fields)
    p = writer.save_gain_map_npz(tmp_path / "map", gm)
    back, md = reader.load_gain_map_npz(p)
    assert type(back).__name__ == "GainMapResult"
    assert type(back).__module__.startswith(reader.__name__.rsplit(".", 1)[0])
    for k in ("x", "pump_powers", "gain", "ok"):
        np.testing.assert_array_equal(getattr(back, k), fields[k])
    assert (back.gain_unit, back.elapsed_s, back.points_per_s) == ("linear", 1.5, 8.0)
    assert md["gain_unit"] == "linear"


@pytest.mark.parametrize("direction", sorted(PAIRS))
def test_run_bundle_round_trip(tmp_path, direction):
    writer, reader = PAIRS[direction]
    z, A = _trajectory(3)
    cfg = T.custom_simulation_config(z_max=5.0, dz=0.1)
    md = writer.make_run_metadata({"run": "bundle"}, config=cfg)
    paths = writer.save_run_bundle(tmp_path / "out", "run1", z, A, metadata=md)
    assert sorted(paths) == ["csv", "json", "npz"]
    z2, A2, md2 = reader.load_result_npz(paths["npz"])
    np.testing.assert_array_equal(z2, z)
    np.testing.assert_array_equal(A2, A)
    assert md2["run"] == "bundle" and md2["config"]["dz"] == 0.1
    assert reader.load_metadata_json(paths["json"]) == md2
    with open(paths["csv"], newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "z" and rows[0][1] == "P_pump 1" and len(rows) == 8
    np.testing.assert_allclose([float(r[3]) for r in rows[1:]], np.abs(A[:, 2]) ** 2, rtol=1e-15)


def test_port_metadata_names_the_port_and_serializes_tensors(tmp_path):
    md = tio.make_run_metadata({"gain": torch.arange(3.0)}, include_device_info=True)
    assert md["psa_torch_version"] == T.__version__
    assert md["backend"] in ("cpu", "cuda") and "torch_version" in md
    assert "jax_version" not in md
    p = tio.save_metadata_json(tmp_path / "md", md)
    assert json.loads(p.read_text())["gain"] == [0.0, 1.0, 2.0]
