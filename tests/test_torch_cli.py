"""The port's command line, ``python -m
psa_simulation_ode_rk_mvp_dispersion_tpu_torch``, on the CPU (``--device
cpu``): the JAX package's CLI tests on the port, its subcommands and flags
against the JAX parser's, the refusals, the loud failure without a card,
the result files read across the two packages, and a run in which JAX and
the JAX package cannot be imported at all."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psa_simulation_ode_rk_mvp_dispersion_tpu import __main__ as jcli  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu import experiments as JE  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu import io_fwm as jio  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import __main__ as cli  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import io_fwm as tio  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PKG = "psa_simulation_ode_rk_mvp_dispersion_tpu_torch"
JAX_PKG = "psa_simulation_ode_rk_mvp_dispersion_tpu"
PORTED = ("single", "spectrum", "spectrum-dbeta", "mismatch", "psa-phase", "gain-map", "comb",
          "kerr-cavity", "gnlse", "vgnlse", "supercontinuum", "sbs", "noise-figure",
          "gain-ripple", "squeezing", "soliton-squeezing", "jitter", "link", "mi-noise",
          "fit-gain")


def _env(**extra):
    env = {"PYTHONPATH": str(ROOT), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "MPLBACKEND": "Agg", "HOME": os.environ.get("HOME", "/tmp")}
    env.update(extra)
    return env


def _cli(*args, timeout=300, **env):
    return subprocess.run([sys.executable, "-m", PKG, *args], capture_output=True, text=True,
                          env=_env(**env), timeout=timeout, cwd=str(ROOT))


def _subparsers(parser):
    (action,) = [a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction"]
    return action.choices


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_pyproject_installs_the_psa_torch_command(capsys):
    """``[project.scripts]`` names ``psa-torch``; its entry point resolves to
    the port's ``main``, which builds the parser named ``psa-torch`` and
    exits 0 on ``--help``.  ``psa-tpu`` stays the JAX package's."""
    import importlib
    import tomllib

    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["psa-tpu"] == f"{JAX_PKG}.__main__:main"
    module, _, attr = scripts["psa-torch"].partition(":")
    main = getattr(importlib.import_module(module), attr)
    assert main is cli.main and cli.build_parser().prog == "psa-torch"
    with pytest.raises(SystemExit) as exit_:
        main(["--help"])
    assert exit_.value.code == 0 and "usage: psa-torch" in capsys.readouterr().out


def test_help_lists_the_ported_subcommands():
    out = _cli("--help")
    assert out.returncode == 0, out.stderr[-2000:]
    for sub in PORTED:
        assert sub in out.stdout
    assert "--device" in out.stdout and "psa-torch" in out.stdout
    for sub in cli.WAITING:
        assert sub not in out.stdout


def test_subcommands_and_flags_match_the_jax_parser():
    """Each ported subcommand keeps the JAX flags and defaults; the global
    options are the JAX ones plus --device."""
    port, ref = cli.build_parser(), jcli.build_parser()
    ps, js = _subparsers(port), _subparsers(ref)
    assert tuple(ps) == PORTED
    for name in PORTED:
        assert _options(ps[name]) == _options(js[name]), name
    po, jo = _options(port), _options(ref)
    assert po.pop("device") == (("--device",), "cuda", None)
    assert po == jo


def test_cli_mismatch(tmp_path):
    out = _cli("--device", "cpu", "--no-show", "--save-dir", str(tmp_path),
               "mismatch", "--points", "32", "--span", "30")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "best delta_beta" in out.stdout
    assert (tmp_path / "mismatch_scan.npz").exists()
    # the archive reads with the JAX package's loader, to the port's own
    xj, gj, dbj, okj, mdj = jio.load_sweep_npz(tmp_path / "mismatch_scan.npz")
    xt, gt, dbt, okt, mdt = tio.load_sweep_npz(tmp_path / "mismatch_scan.npz")
    for a, b in ((xj, xt), (gj, gt), (okj, okt)):
        np.testing.assert_array_equal(a, b)
    assert mdj["backend"] == "cpu" and mdj == mdt


def test_jax_archives_read_with_the_port_loaders(tmp_path):
    """A sweep and a run bundle written by the JAX package's experiments
    load with the port's io_fwm, and the other way round."""
    JE.gain_spectrum(n_points=4, z_max_m=10.0, show=False, verbose=False, save_dir=str(tmp_path))
    JE.single_simulation(z_max_m=1.0, show=False, verbose=False, save_dir=str(tmp_path))
    x, g, db, ok, md = tio.load_sweep_npz(tmp_path / "gain_spectrum.npz")
    xj, gj, dbj, okj, mdj = jio.load_sweep_npz(tmp_path / "gain_spectrum.npz")
    np.testing.assert_array_equal(g, gj)
    assert md == mdj and ok.dtype == okj.dtype
    z, A, md = tio.load_result_npz(tmp_path / "single_simulation.npz")
    zj, Aj, mdj = jio.load_result_npz(tmp_path / "single_simulation.npz")
    np.testing.assert_array_equal(A, Aj)
    assert md == mdj == tio.load_metadata_json(tmp_path / "single_simulation.json")


def test_zero_arguments_fail_loudly_without_a_card():
    """The zero-argument demo runs on the card; with none it stops with a
    message naming the card and --device cpu, and no CPU fallback runs."""
    out = _cli(CUDA_VISIBLE_DEVICES="", PSA_TPU_DEMO_POINTS="6")
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr and "--device cpu" in out.stderr
    assert "sweep" not in out.stdout


def test_zero_arguments_are_the_spectrum_dbeta_demo_on_the_card(monkeypatch):
    """No arguments run spectrum-dbeta at PSA_TPU_DEMO_POINTS points on the
    card (the experiment is replaced by a recorder, the card's query by
    True)."""
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import experiments as TE

    calls = []
    monkeypatch.setenv("PSA_TPU_DEMO_POINTS", "4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(TE, "gain_spectrum_dbeta", lambda **kw: calls.append(kw))
    assert cli.main([]) == 0
    (kw,) = calls
    assert kw["n_points"] == 4 and kw["device"] == "cuda" and kw["precision"] == "x64"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(cli.NoCardError, match="--device cpu"):
        cli.main([])
    assert len(calls) == 1


def test_shard_runs_the_sweep_over_the_mesh(tmp_path, monkeypatch):
    """``--shard`` builds ``default_mesh`` over the cards of ``--device``
    and hands it to the experiment.  On the CPU that is one slot, so no
    mesh (as one card is in the JAX package), and the files are the
    unsharded run's; a mesh of 3 CPU slots writes the same gains too
    (rtol 1e-12, the sweep's sharded-vs-unsharded bar)."""
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import mesh as pm

    common = ["--device", "cpu", "--no-show", "--quiet"]

    def spectrum(name, *extra):
        assert cli.main(common + ["--save-dir", str(tmp_path / name), *extra, "spectrum",
                                  "--points", "7"]) == 0
        return tio.load_sweep_npz(tmp_path / name / "gain_spectrum.npz")

    plain = spectrum("plain")
    made = []
    real = pm.default_mesh
    monkeypatch.setattr(pm, "default_mesh", lambda **kw: made.append(kw) or real(**kw))
    one = spectrum("one-slot", "--shard")
    monkeypatch.setattr(pm, "default_mesh", lambda **kw: made.append(kw) or real(3, **kw))
    three = spectrum("three-slots", "--shard")
    assert made == [{"device": "cpu"}] * 2
    for g, p, t in zip(one[:4], plain[:4], three[:4]):
        np.testing.assert_array_equal(g, p)
        if p is not None:
            np.testing.assert_allclose(t, p, rtol=1e-12)


@pytest.mark.parametrize("argv, says", [
    (["--integrator", "rk45", "sbs"], "not honored by 'sbs'"),
    (["--integrator", "rk4", "comb"], "--comb-integrator"),
    (["--integrator", "rk4", "fit-gain", "a.npz"], "not honored by 'fit-gain'"),
    (["bench"], "ROADMAP item 7"),
    (["supercontinuum", "--vector", "--coherence", "4"], "--coherence is scalar-only"),
])
def test_refusals_name_what_they_wait_for(capsys, argv, says):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert says in capsys.readouterr().err


def test_cli_fit_gain(tmp_path, capsys):
    """``mismatch`` and then ``fit-gain`` on its archive, on the CPU: the
    fit's line on stdout and ``fit_gain.npz`` (the calibration slice,
    ROADMAP item 16)."""
    common = ["--device", "cpu", "--no-show", "--save-dir", str(tmp_path)]
    assert cli.main(common + ["--quiet", "mismatch", "--points", "8", "--span", "30"]) == 0
    assert cli.main(common + ["fit-gain", str(tmp_path / "mismatch_scan.npz"), "--steps",
                              "3"]) == 0
    assert "fitted over 8 points in 3 steps" in capsys.readouterr().out
    with np.load(tmp_path / "fit_gain.npz") as z:
        assert z["loss_history"].shape == (4,) and np.isfinite(z["gamma"])


def test_the_port_runs_without_jax():
    """In a process where jax and the JAX package cannot be imported, every
    module of the port imports, and the command line answers --help."""
    script = f"""
import importlib, pkgutil, runpy, sys

BLOCKED = ("jax", "jaxlib", "{JAX_PKG}", "psa_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name in BLOCKED or name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import {PKG} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("imported", " ".join(names))
sys.argv = ["psa-torch", "--help"]
try:
    runpy.run_module("{PKG}", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_env(), timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    imported = set(out.stdout.split("imported ", 1)[1].splitlines()[0].split())
    for sub in ("__main__", "experiments", "experiments.fwm4", "experiments.comb",
                "experiments.lle", "experiments.pulses", "experiments.sbs", "models.sbs",
                "plotting", "utils.debug", "utils.observability", "parallel.sweep",
                "parallel.noise", "parallel.fluctuations", "parallel.link",
                "experiments.noise", "experiments.fluctuations", "parallel.calibrate",
                "experiments.fitting", "ops.cuda_tangent", "parallel.mesh"):
        assert f"{PKG}.{sub}" in imported, sub
    assert "usage: psa-torch" in out.stdout
