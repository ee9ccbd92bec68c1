"""The benchmark's yardstick on the CPU: the plain references agree with the
port's own physics at tiny sizes, the comparison fails the lower precision,
and the frozen counts give the kernel table's bounds."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import comb as ref_comb
from benchmark.reference import counts
from benchmark.reference import fwm4 as ref
from benchmark.reference.compare import Gap, db, sample_rows

BENCH = Path(__file__).resolve().parents[1]
LAM1, LAM2 = 1550e-9, 1555e-9


def _lanes(n, seed=3):
    rng = np.random.default_rng(seed)
    lam = np.linspace(1540e-9, 1650e-9, n) + rng.uniform(-0.1, 0.1, n) * 1e-9
    p = rng.uniform(0.05, 0.5, n)
    A0 = np.sqrt(np.stack([p, p, np.full(n, 1e-7), np.full(n, 1e-7)], axis=1)).astype(complex)
    return lam, A0


def test_delta_beta_matches_the_ports_phase_matching():
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.phase_matching import (
        dispersion_at_pump_center)
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import sweep
    lam, _ = _lanes(64)
    _, _, disp = dispersion_at_pump_center(LAM1, LAM2, float(lam[0]), D=0.2, S=0.02)
    db_port = sweep.dbeta_spectrum(lambda_p1_m=LAM1, lambda_p2_m=LAM2, lambda_signal_m=lam,
                                   dispersion=disp, device="cpu")[1]
    db_ref, valid = ref.delta_beta(LAM1, LAM2, lam, 0.2, 0.02)
    assert valid.all()
    np.testing.assert_allclose(db_ref, db_port, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_fwm4_reference_matches_the_ports_plain_solve(integrator):
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive, cuda_solver
    lam, A0 = _lanes(12)
    dbeta, _ = ref.delta_beta(LAM1, LAM2, lam, 0.2, 0.02)
    g, a = np.full(12, 11.5e-3), np.full(12, 1.1513e-4)
    kw = dict(dz_m=0.2, n_steps=100, save_every=10)
    t = [torch.as_tensor(v) for v in (A0, g, a, dbeta)]
    if integrator == "rk4":
        port = cuda_solver.solve_batch_torch(*t, **kw)
        pmax, ok = ref.rk4(A0, g, a, dbeta, dz=0.2, n_steps=100, save_every=10)
    else:
        port = cuda_adaptive.solve_batch_rk45_torch(*t, rtol=1e-9, atol=1e-12, **kw)
        pmax, ok, _ = ref.dp45(A0, g, a, dbeta, dz=0.2, n_steps=100, save_every=10,
                               rtol=1e-9, atol=1e-12)
    assert ok.all() and port.ok.numpy().all()
    np.testing.assert_allclose(pmax, port.P_max.numpy(), rtol=1e-12)


def test_dp45_reference_meets_its_tolerance_against_rk4():
    """The adaptive reference at rtol 1e-9 lands within ~1e-7 of a fine
    fixed-step RK4 of the same model: its controller controls the error."""
    lam, A0 = _lanes(6)
    dbeta, _ = ref.delta_beta(LAM1, LAM2, lam, 0.2, 0.02)
    g, a = np.full(6, 11.5e-3), np.full(6, 1.1513e-4)
    fine, _ = ref.rk4(A0, g, a, dbeta, dz=0.01, n_steps=4000, save_every=400)
    adapt, ok, att = ref.dp45(A0, g, a, dbeta, dz=0.2, n_steps=200, save_every=20,
                              rtol=1e-9, atol=1e-12)
    assert ok.all() and (att > 10).all()
    np.testing.assert_allclose(adapt, fine, rtol=1e-7)


def test_comb_direct_sum_matches_the_ports_fft_coupling():
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.normal(size=(3, 64)) + 1j * rng.normal(size=(3, 64)))
    direct = ref_comb.DirectSum(64, "cpu")(a)
    torch.testing.assert_close(direct, nwave.fwm_polarization(a), rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(direct, nwave.fwm_polarization_direct(a), rtol=1e-12,
                               atol=1e-10)


def test_comb_beta_matches_the_ports_taylor_lines():
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.dispersion import DispersionParams
    wc, dw = 2 * np.pi * 193.1e12, 2 * np.pi * 50e9
    grid = nwave.CombGrid.centered(wc, dw, 64)
    disp = DispersionParams.from_betas(wc, beta2=-1e-27, beta3=1.2e-41)
    port = nwave.comb_beta_lin(grid, disp)
    np.testing.assert_allclose(ref_comb.beta_lines(64, dw, -1e-27, 1.2e-41), port,
                               rtol=1e-9, atol=1e-12)


def test_comb_reference_matches_the_ports_plain_solve():
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb
    rng = np.random.default_rng(9)
    B, n = 3, 16
    A0 = np.sqrt(1e-9) * np.exp(2j * np.pi * rng.random((B, n)))
    A0[:, [4, 12]] = np.sqrt(0.5)
    gam = rng.uniform(5e-3, 15e-3, B)
    beta = ref_comb.beta_lines(n, 2 * np.pi * 50e9, -1e-27, 1.2e-41)
    pmax, p_end, ok = ref_comb.rk4(A0, gam, 5e-5, beta, dz=0.5, n_steps=40, save_every=10)
    t = [torch.as_tensor(v) for v in (A0, gam, np.full(B, 5e-5), np.tile(beta, (B, 1)))]
    port = cuda_comb.solve_comb_batch_torch(*t, dz_m=0.5, n_steps=40, save_every=10,
                                            coupling="fft")
    assert ok.all()
    np.testing.assert_allclose(pmax, port.P_max.numpy(), rtol=1e-11)
    np.testing.assert_allclose(p_end, np.abs(port.A_end.numpy()) ** 2, rtol=1e-11)


def test_the_comparison_fails_float32_and_passes_float64():
    """The control on a few lanes at the configuration's length: the
    reference in float32, put in the program's place, fails the 4-wave
    cell's limit, which float64 meets."""
    limit = json.loads((BENCH / "traffic" / "spectrum-10k-rk45.json").read_text())
    limit = limit["limit_gain_gap_db"]
    lam, A0 = _lanes(8)
    dbeta, valid = ref.delta_beta(LAM1, LAM2, lam, 0.2, 0.02)
    g, a = np.full(8, 11.5e-3), np.full(8, 1.1513e-4)
    kw = dict(dz=0.2, n_steps=2500, save_every=10)
    p64, ok64 = ref.rk4(A0, g, a, dbeta, **kw)
    p32, ok32 = ref.rk4(A0, g, a, dbeta, dtype=np.float32, **kw)
    g64 = ref.gain_db(p64[:, 2], 1e-7, ok64 & valid)
    gap32, gap64 = Gap(), Gap()
    gap32.add(ref.gain_db(p32[:, 2], 1e-7, ok32 & valid), g64, ok32, ok64)
    gap64.add(g64, g64, ok64, ok64)
    assert gap64.checks("gain", limit)["gain_gap_db"].passed
    assert not gap32.checks("gain", limit)["gain_gap_db"].passed


def test_a_mismatched_ok_flag_or_an_empty_comparison_fails():
    gap = Gap()
    gap.add([1.0, np.nan], [1.0, 2.0], [True, False], [True, True])
    assert gap.checks("gain", 1.0)["ok_mismatch"].value == 1
    assert not Gap().checks("gain", 1.0)["gain_gap_db"].passed
    assert np.isnan(db([0.0]))[0] and db([10.0])[0] == 10.0


def test_sample_rows_covers_every_shard():
    rows = sample_rows(np.random.default_rng(1), 16384, 64, 4)
    assert len(set(rows)) == 64 and (np.bincount(rows // 4096, minlength=4) == 16).all()


def test_counts_reproduce_the_kernel_tables_bounds():
    """PERF.md's kernel table: K1 0.398 ms at 10^4 lanes x 2,500 steps, K4
    5.259 ms at 4,096 combs of 64 lines x 1,000 steps (fp64, operations)."""
    flop, nbytes = counts.fwm4_rk_work(10_000, 2500, 10)
    assert round(1e3 * counts.least_seconds(flop, nbytes), 3) == 0.398
    flop, nbytes = counts.comb_rk_work(4096, 64, 1000, 100)
    assert round(1e3 * counts.least_seconds(flop, nbytes), 3) == 5.259
    assert counts.comb_fft_len(64) == 128
    # K1's bound at a 64 x 4,096 gain map's 262,144 lanes
    flop, nbytes = counts.fwm4_rk_work(262_144, 2500, 10)
    assert 10.4e-3 < counts.least_seconds(flop, nbytes) < 10.5e-3
