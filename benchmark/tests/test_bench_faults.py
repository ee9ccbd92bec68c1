"""A run of every cell on the CPU, with the look for a card skipped, at a size
the CPU holds: sound, it comes out correct; with the timed path broken
underneath, or at the program's lower precision, it comes out not correct.

The faults are planted in the port's plain solvers (the path the CPU runs
in place of the kernels) and in its mesh gather, where each answer is
produced:

- ``unchanged``: a solve that returns its initial state;
- ``half``: the second half of the batch left out (its rows never solved);
- ``altered``: every answer changed where it is produced, by twice the
  cell's limit;
- ``no_exchange``: the gather between cards left out, every shard's rows
  taken from the first card's (the cell over four cards).
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import pytest
import torch

from benchmark import run

PORT = "psa_simulation_ode_rk_mvp_dispersion_tpu_torch"
SEED = 2**31 + 977

# sizes the CPU holds; every instance of a job is in the sample.  The 4-wave
# band is cut to wavelengths near the pumps, where every signal gains: a lane
# whose largest power is its input reads the same whether it was solved or
# not, so no fault shows in it.
NEAR = dict(z_max_m=100.0, signal_band_nm=[1556.0, 1566.0])
SMALL = {
    "fwm4-spectrum-rk45": dict(wavelengths=6, sample_per_set=6, physics=NEAR),
    "comb-rk4": dict(combs=6, sample_per_set=6,
                     physics=dict(z_max_m=50.0, n_steps=100, save_every=10)),
    "comb-rk4-x4": dict(combs=8, sample_per_set=8,
                        physics=dict(z_max_m=50.0, n_steps=100, save_every=10)),
}


def _run(workload, overrides=None, precision=None, trace=False):
    ov = dict(SMALL[workload], input_sets=2, **(overrides or {}))
    return run.run_cell(workload, SEED, 0.2, trace, device="cpu", overrides=ov,
                        precision=precision, t_start=time.perf_counter())


def _limit_factor(workload):
    """The power factor that moves a value by twice the cell's limit in dB."""
    cell, _config, _driver, traffic = run.load_cell(run.load_manifest(), workload)
    limit = traffic.get("limit_gain_gap_db", traffic.get("limit_line_gap_db"))
    return 10 ** (2 * limit / 10)


def _solvers(workload):
    """``[(module, attribute)]`` of the plain solvers the cell's CPU run calls."""
    if workload.startswith("comb"):
        return [(importlib.import_module(PORT + ".ops.cuda_comb"), "solve_comb_batch_torch")]
    sweep = importlib.import_module(PORT + ".parallel.sweep")
    return [(sweep, "solve_batch_torch"), (sweep, "solve_batch_rk45_torch")]


def _broken(solver, fault, factor):
    def solve(A0, *args, **kwargs):
        r = solver(A0, *args, **kwargs)
        p0 = A0.real ** 2 + A0.imag ** 2
        if fault == "unchanged":
            return dataclasses.replace(r, P_max=p0, A_end=A0.clone())
        if fault == "half":
            h = A0.shape[0] // 2
            return dataclasses.replace(
                r, P_max=torch.cat([r.P_max[:h], p0[h:]]),
                A_end=torch.cat([r.A_end[:h], A0[h:]]))
        return dataclasses.replace(r, P_max=r.P_max * factor)
    return solve


def _no_exchange(fetch):
    mesh = importlib.import_module(PORT + ".parallel.mesh")

    def fetch_global(x):
        if isinstance(x, mesh.ShardedArray):
            first = x.shards[0]
            x = dataclasses.replace(x, shards=tuple(first for _ in x.shards))
        return fetch(x)
    return fetch_global


CASES = [(w, f) for w in SMALL for f in ("unchanged", "half", "altered")]
CASES.append(("comb-rk4-x4", "no_exchange"))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_comes_out_correct(workload):
    line, checks, notes = _run(workload)
    assert line["correct"], notes
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"instances_per_s", "job_p95_ms", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert notes[-len(checks):] == [f"{k} {c.value!r} limit {c.limit!r}"
                                    for k, c in checks.items()]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_comes_out_not_correct(workload, fault, monkeypatch):
    if fault == "no_exchange":
        mesh = importlib.import_module(PORT + ".parallel.mesh")
        monkeypatch.setattr(mesh, "fetch_global", _no_exchange(mesh.fetch_global))
    else:
        factor = _limit_factor(workload)
        for mod, name in _solvers(workload):
            monkeypatch.setattr(mod, name, _broken(getattr(mod, name), fault, factor))
    line, checks, notes = _run(workload)
    assert not line["correct"], notes
    assert not all(c.passed for c in checks.values())


@pytest.mark.parametrize("workload", ["fwm4-spectrum-rk45", "comb-rk4"])
def test_the_programs_float32_path_comes_out_not_correct(workload):
    """The control: the program's ``x32`` path at the configuration's own
    length, on a few instances."""
    full = {"fwm4-spectrum-rk45": dict(physics=dict(z_max_m=500.0)),
            "comb-rk4": dict(physics=dict(z_max_m=500.0, n_steps=1000, save_every=100))}
    line, _checks, notes = _run(workload, full[workload], precision="x32")
    assert not line["correct"], notes


def test_a_traced_run_reports_its_window_and_breakdown():
    line, _checks, notes = _run("comb-rk4", trace=True)
    assert line["correct"], notes
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    # no device operation on the CPU: the device metrics find nothing to read
    assert line["metrics"] == {}
    assert np.isfinite(line["device"]["busy_s"])
