"""The public signatures of the PyTorch port against the JAX package's.

For every module of the port that has a counterpart of the same path in the
JAX package, each public function and class defined there that the JAX
module also has must take the JAX parameters, by name and in order.  The
port may add only the documented extras:

- ``device``: where a solve runs (``None``: the CUDA card);
- ``batch_ndim`` (``ops/integrators``, ``ops/adaptive``): the count of
  leading batch axes, which the JAX package gets from ``vmap``;
- ``comp`` (``ops/integrators.IntegrationState``): the compensated-summation
  term of the float32 steps.

A keyword the JAX package takes for its compiler alone (``unroll``) is
accepted by the port and has no effect there.
"""

import importlib
import inspect

import numpy as np
import pytest

pytest.importorskip("torch")

import psa_torch as T  # noqa: E402

JAX_PKG = "psa_simulation_ode_rk_mvp_dispersion_tpu"
PORT_PKG = JAX_PKG + "_torch"
MODULES = [
    "config", "constants", "io_fwm", "models.fwm4", "models.gnlse", "models.lle",
    "models.nwave", "models.vgnlse", "ops.adaptive", "ops.analytic", "ops.dispersion",
    "ops.frequency_plan", "ops.integrators", "ops.phase_matching", "ops.rhs", "parallel.sweep",
    "utils.checks", "utils.precision", "utils.units",
    "experiments.fwm4", "experiments.comb", "experiments.lle", "experiments.pulses",
    "experiments.sbs", "models.sbs", "plotting", "utils.observability", "utils.debug",
    "parallel.noise", "parallel.fluctuations", "parallel.link", "experiments.noise",
    "experiments.fluctuations", "parallel.calibrate", "experiments.fitting", "parallel.mesh",
]
EXTRAS = {"device"}
MODULE_EXTRAS = {"ops.integrators": {"batch_ndim", "comp"}, "ops.adaptive": {"batch_ndim"}}


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):   # a builtin or an enum without a signature
        return None


@pytest.mark.parametrize("module", MODULES)
def test_public_signatures_match_the_jax_package(module):
    port = importlib.import_module(f"{PORT_PKG}.{module}")
    ref = importlib.import_module(f"{JAX_PKG}.{module}")
    extras = EXTRAS | MODULE_EXTRAS.get(module, set())
    compared, differ = 0, []
    for name, obj in vars(port).items():
        if name.startswith("_") or not callable(obj) or getattr(obj, "__module__", None) != \
                port.__name__ or not hasattr(ref, name):
            continue
        mine, theirs = _params(obj), _params(getattr(ref, name))
        if mine is None or theirs is None:
            continue
        compared += 1
        if [p for p in mine if p not in extras] != theirs:
            differ.append(f"{name}: port {mine}, JAX {theirs}")
    assert not differ, "\n".join(differ)
    assert compared > 0 or module == "constants"


def test_the_four_wave_solvers_accept_unroll():
    """The keyword the JAX scans take for their unroll factor."""
    for module, names in (("parallel.sweep", ("solve_batch", "solve_batch_trajectories")),
                          ("ops.integrators", ("integrate_fixed_grid", "integrate_reduce"))):
        port = importlib.import_module(f"{PORT_PKG}.{module}")
        for name in names:
            p = inspect.signature(getattr(port, name)).parameters["unroll"]
            assert p.default == 4 and p.kind is inspect.Parameter.KEYWORD_ONLY
    cfg = T.custom_simulation_config(z_max=1.0, dz=0.1)
    coeffs = T.RHSCoeffs(np.full(2, 0.01), np.zeros(2), np.zeros(2))
    A0 = np.full((2, 4), 0.1, dtype=np.complex128)
    a = T.solve_batch(cfg, coeffs, A0, unroll=8, device="cpu")
    b = T.solve_batch(cfg, coeffs, A0, device="cpu")
    assert np.array_equal(a.A_end, b.A_end)
    z, A, ok = T.solve_batch_trajectories(cfg, coeffs, A0, unroll=1, device="cpu")
    assert ok.all() and A.shape[0] == 2 and A.shape[1] == len(z)


def test_the_cli_has_the_jax_subcommands_but_those_waiting_in_the_roadmap():
    """The JAX parser's subcommands are the port's plus the waiting list,
    and ROADMAP.md names each waiting subcommand with its item."""
    from pathlib import Path

    from psa_simulation_ode_rk_mvp_dispersion_tpu import __main__ as jcli
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import __main__ as cli

    def subcommands(parser):
        (action,) = [a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction"]
        return set(action.choices)

    port, ref = subcommands(cli.build_parser()), subcommands(jcli.build_parser())
    assert not port & set(cli.WAITING)
    assert ref == port | set(cli.WAITING)
    roadmap = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    for name, item in cli.WAITING.items():
        assert f"`{name}`" in roadmap, name
    for item in set(cli.WAITING.values()):
        assert f"\n{item}. " in roadmap
