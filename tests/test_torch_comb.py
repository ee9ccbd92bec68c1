"""The comb kernel modules of the PyTorch port, ``ops/cuda_comb.py`` (K4) and
``ops/cuda_comb_adaptive.py`` (K5), through their plain versions on the CPU.

Tolerances (normwise: of the largest value of each comb, since a weak
noise-seeded line carries the DFT sums' rounding relative to the pumps):

- the plain versions' default coupling (``ops/cuda_comb.kernel_polarization``,
  the comb kernels' radix-4 passes and rounding points) vs ``models/nwave``'s
  'fft' and 'dft' couplings: 1e-13 in fp64, 2e-6 in fp32 (a few float32
  roundings of the largest line);
- fixed-step fp64 rk4/ab4/abm4 vs the JAX x64 scan with the dft coupling:
  1e-12 in ``A_end`` and ``P_max``;
- rk45 fp64 at rtol 1e-10 vs the JAX x64 scan: 1e-7 (the port's
  controller integrates each segment in local z);
- fp32 rk4 vs the JAX K4 kernel (``ops/pallas_comb.py``) in interpret mode
  at N=8, B=4, 100 steps: rtol 2e-5 with atol 1e-7, the bar of
  ``tests/test_nwave.py:326``;
- fp32 rk45 vs the JAX K5 kernel in interpret mode at N=16, B=16: the
  controllers differ (first step, FSAL, the factor's form), so the two take
  other steps and are held to that kernel's tolerance class, 2e-2 in power
  (``tests/test_nwave.py:524``); step counts are never compared;
- NaN freeze: the blown-up lane keeps a finite state and clears ``ok``, as in
  the JAX scan; the other lanes agree to 1e-12.

The CUDA kernels themselves are compared with these plain versions on the
card in ``tests/test_torch_kernel.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import nwave as jn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import pallas_comb as jpc  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import pallas_comb_adaptive as jpca  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb as cc  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb_adaptive as cca  # noqa: E402

torch.set_num_threads(1)

OMEGA_C = 2 * np.pi * 193.1e12


def _normwise(a, b):
    """Worst over combs of max_lines |a - b| / max_lines |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.max(np.abs(a - b), axis=-1) / np.max(np.abs(b), axis=-1)))


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("N", [16, 100, 600, 1100], ids=["L128", "L256", "L2048", "L4096"])
def test_kernel_polarization_matches_the_model_couplings(N, rdt):
    """The cubic sum as the comb kernels round it, at L = 128, 256 (one
    radix-2 pass first), 2,048 and 4,096, against the FFT and dense-DFT
    couplings of models/nwave in the same type, on seeded random lines."""
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave as tn
    rng = np.random.default_rng(N)
    a = torch.as_tensor(rng.standard_normal((3, N)) + 1j * rng.standard_normal((3, N)))
    a = a.to(torch.complex128 if rdt == torch.float64 else torch.complex64)
    k = cc.kernel_polarization(a)
    assert k.dtype == a.dtype and k.shape == a.shape
    assert cc.kernel_fft_len(N) == {16: 128, 100: 256, 600: 2048, 1100: 4096}[N]
    bar = 1e-13 if rdt == torch.float64 else 2e-6
    for ref in (tn.fwm_polarization(a), tn.fwm_polarization_dft(a)):
        assert _normwise(k.numpy(), ref.numpy()) <= bar


def _bench_comb(n=16, B=6, seed=0):
    """bench_comb.py:94-115 at small size: pumps at c +- n/4, a noise floor,
    a gamma grid."""
    grid = jn.CombGrid.centered(OMEGA_C, 2 * np.pi * 50e9, n)
    disp = J.DispersionParams.from_betas(OMEGA_C, beta2=-1e-27, beta3=1.2e-41)
    beta = jn.comb_beta_lin(grid, disp)
    c = n // 2
    A0 = jn.seed_comb(grid, pump_lines={c - n // 4: 0.5, c + n // 4: 0.5}, noise_floor_W=1e-9,
                      seed=seed)
    return (np.broadcast_to(A0, (B, n)).copy(), np.linspace(5e-3, 15e-3, B), np.full(B, 5e-5),
            np.broadcast_to(beta, (B, n)).copy())


def _tensors(A0, g, a, beta, rdt=torch.float64):
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return (torch.as_tensor(A0, dtype=cdt), *(torch.as_tensor(v, dtype=rdt) for v in (g, a, beta)))


def _jax_scan(A0, g, a, beta, *, n_steps, dz, integrator, save_every=10, precision="x64",
              rtol=1e-10, atol=1e-14):
    cfg = J.custom_simulation_config(z_max=n_steps * dz, dz=dz, save_every=save_every,
                                     precision=precision, integrator=integrator, rtol=rtol,
                                     atol=atol)
    return jn.solve_comb_batch(cfg, jn.NWaveCoeffs(gamma=g, alpha=a, beta_lin=beta), A0,
                               coupling="dft", engine="scan")


@pytest.mark.parametrize("integrator", ["rk4", "ab4", "abm4"])
@pytest.mark.parametrize("n_steps", [100, 105])
def test_plain_fp64_matches_jax_x64_scan(integrator, n_steps):
    A0, g, a, beta = _bench_comb()
    r = cc.solve_comb_batch_torch(*_tensors(A0, g, a, beta), dz_m=5.0, n_steps=n_steps,
                                  save_every=10, integrator=integrator)
    Pj, Aj, okj = _jax_scan(A0, g, a, beta, n_steps=n_steps, dz=5.0, integrator=integrator)
    assert r.P_max.dtype == torch.float64 and r.A_end.dtype == torch.complex128
    assert r.ok.all() and okj.all()
    assert _normwise(r.A_end.numpy(), Aj) <= 1e-12
    assert _normwise(r.P_max.numpy(), Pj) <= 1e-12


@pytest.mark.parametrize("n_steps", [100, 105])
def test_plain_rk45_matches_jax_x64_scan(n_steps):
    A0, g, a, beta = _bench_comb()
    r = cca.solve_comb_batch_rk45_torch(*_tensors(A0, g, a, beta), dz_m=5.0, n_steps=n_steps,
                                        save_every=10, rtol=1e-10, atol=1e-14)
    Pj, Aj, okj = _jax_scan(A0, g, a, beta, n_steps=n_steps, dz=5.0, integrator="rk45")
    assert r.ok.all() and okj.all() and bool((r.n_accepted > 0).all())
    assert r.n_accepted.dtype == torch.int32
    assert _normwise(r.A_end.numpy(), Aj) <= 1e-7
    assert _normwise(r.P_max.numpy(), Pj) <= 1e-7


@pytest.mark.parametrize("n_steps", [100, 105])
def test_plain_fp32_matches_jax_k4_interpret(n_steps):
    """tests/test_nwave.py:311-327's inputs; 105 steps leave a trailing
    unsaved interval."""
    n, B = 8, 4
    rng = np.random.default_rng(2)
    A0 = rng.normal(size=(B, n)) * 0.3 + 1j * rng.normal(size=(B, n)) * 0.3
    g, a = np.linspace(0.5, 1.5, B), np.full(B, 0.02)
    beta = np.broadcast_to(np.linspace(-0.3, 0.3, n), (B, n)).copy()
    r = cc.solve_comb_batch_torch(*_tensors(A0, g, a, beta, torch.float32), dz_m=0.01,
                                  n_steps=n_steps, save_every=10)
    Pk, Ak, okk = jpc.solve_comb_batch_pallas(A0, g, a, beta, dz_m=0.01, n_steps=n_steps,
                                              save_every=10, interpret=True)
    assert r.P_max.dtype == torch.float32 and r.ok.all() and okk.all()
    np.testing.assert_allclose(r.A_end.numpy(), Ak, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(r.P_max.numpy(), Pk, rtol=2e-5, atol=1e-7)


def test_plain_fp32_rk45_matches_jax_k5_interpret_class():
    """tests/test_nwave.py:490-526's configuration: N=16, B=16, 60 steps of
    5 m, save_every 20, rtol 1e-6."""
    N, B = 16, 16
    grid = jn.CombGrid.centered(OMEGA_C, 2 * np.pi * 50e9, N)
    disp = J.DispersionParams.from_betas(OMEGA_C, beta2=-1e-27)
    beta = np.broadcast_to(jn.comb_beta_lin(grid, disp), (B, N)).copy()
    A0 = np.broadcast_to(jn.seed_comb(grid, pump_lines={6: 0.4, 10: 0.4}, noise_floor_W=1e-9,
                                      seed=0), (B, N)).copy()
    g, a = np.linspace(5e-3, 15e-3, B), np.full(B, 5e-5)
    kw = dict(dz_m=5.0, n_steps=60, save_every=20, rtol=1e-6, atol=1e-12)
    r = cca.solve_comb_batch_rk45_torch(*_tensors(A0, g, a, beta, torch.float32), **kw)
    rk = jpca.solve_comb_batch_rk45_pallas(A0, g, a, beta, interpret=True, **kw)
    assert r.ok.all() and rk.ok.all()
    P_t, P_k = np.abs(r.A_end.numpy()) ** 2, np.abs(rk.A_end) ** 2
    sig = P_k > 1e-9
    assert np.max(np.abs(P_t[sig] / P_k[sig] - 1)) < 2e-2
    np.testing.assert_allclose(r.P_max.numpy(), rk.P_max, rtol=2e-2, atol=1e-10)


@pytest.mark.parametrize("integrator", ["rk4", "abm4"])
def test_nan_lane_freezes_like_jax(integrator):
    A0, g, a, beta = _bench_comb(n=8, B=3)
    A0[1] *= 1e3
    g[1] = 1e3                                        # lane 1 blows up
    r = cc.solve_comb_batch_torch(*_tensors(A0, g, a, beta), dz_m=5.0, n_steps=40,
                                  save_every=10, integrator=integrator)
    with np.errstate(all="ignore"):
        Pj, Aj, okj = _jax_scan(A0, g, a, beta, n_steps=40, dz=5.0, integrator=integrator)
    assert r.ok.tolist() == [True, False, True] == okj.tolist()
    assert torch.isfinite(r.A_end).all() and torch.isfinite(r.P_max).all()
    np.testing.assert_allclose(r.A_end.numpy()[1], Aj[1], rtol=1e-12)
    keep = [0, 2]
    assert _normwise(r.A_end.numpy()[keep], Aj[keep]) <= 1e-12
    # rk45: the lane fails within its dt_min rejections and keeps its state
    r45 = cca.solve_comb_batch_rk45_torch(*_tensors(A0, g, a, beta), dz_m=5.0, n_steps=40,
                                          save_every=10, rtol=1e-8, atol=1e-12)
    assert r45.ok.tolist() == [True, False, True] and torch.isfinite(r45.A_end).all()


def test_check_nan_off_keeps_ok():
    A0, g, a, beta = _bench_comb(n=8, B=2)
    g[1], A0[1] = 1e3, A0[1] * 1e3
    with np.errstate(all="ignore"):
        r = cc.solve_comb_batch_torch(*_tensors(A0, g, a, beta), dz_m=5.0, n_steps=40,
                                      save_every=10, check_nan=False)
    assert r.ok.all() and not torch.isfinite(r.A_end[1]).all()


def test_no_steps_and_short_runs_return_the_input():
    A0, g, a, beta = _bench_comb(n=8, B=2)
    t = _tensors(A0, g, a, beta)
    for n_steps in (0, 7):
        r = cc.solve_comb_batch_torch(*t, dz_m=5.0, n_steps=n_steps, save_every=10)
        r45 = cca.solve_comb_batch_rk45_torch(*t, dz_m=5.0, n_steps=n_steps, save_every=10,
                                              rtol=1e-8, atol=1e-12)
        for res in (r, r45):
            assert torch.equal(res.A_end, t[0]) and res.ok.all()
            assert torch.equal(res.P_max, t[0].real ** 2 + t[0].imag ** 2)
        if n_steps == 0:
            assert int(r45.n_accepted.sum()) == 0
        else:
            assert bool((r45.n_accepted > 0).all())   # the unsaved span is integrated


def test_kernel_wrappers_refuse_cpu_and_bad_inputs():
    A0, g, a, beta = _bench_comb(n=8, B=3)
    t = _tensors(A0, g, a, beta)
    launches = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cc.solve_comb_batch_cuda(*t, dz_m=5.0, n_steps=10, save_every=10)
    with pytest.raises(ValueError, match="CUDA"):
        cca.solve_comb_batch_rk45_cuda(*t, dz_m=5.0, n_steps=10, save_every=10, rtol=1e-8,
                                       atol=1e-12)
    with pytest.raises(ValueError, match="beta_lin"):
        cc.solve_comb_batch_torch(*t[:3], t[3][:, :4].contiguous(), dz_m=5.0, n_steps=10,
                                  save_every=10)
    with pytest.raises(ValueError, match="gamma"):
        cc.solve_comb_batch_torch(t[0], t[1].float(), t[2], t[3], dz_m=5.0, n_steps=10,
                                  save_every=10)
    with pytest.raises(ValueError, match="contiguous"):
        cc.solve_comb_batch_torch(*t[:3], t[3].T.contiguous().T, dz_m=5.0, n_steps=10,
                                  save_every=10)
    with pytest.raises(ValueError, match="integrator"):
        cc.solve_comb_batch_torch(*t, dz_m=5.0, n_steps=10, save_every=10, integrator="rk45")
    with pytest.raises(ValueError, match="rtol"):
        cca.solve_comb_batch_rk45_torch(*t, dz_m=5.0, n_steps=10, save_every=10, rtol=0.0,
                                        atol=1e-12)
    assert dict(_build.LAUNCHES) == launches


def test_twiddle_table_matches_the_dense_matrices():
    """The kernels' weights W[j, m] = tw[(j*m) mod L] are the plain
    version's matrices, bit for bit, in both dtypes."""
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave as tn

    for n in (3, 16):
        L = tn._fft_len(n)
        for rdt in (torch.float64, torch.float32):
            tw = cc.twiddles(L, rdt, "cpu")
            wf, wi = tn._dft_mats(n, rdt, "cpu")
            k = (np.arange(n)[:, None] * np.arange(L)[None, :]) % L
            c, s = tw[k, 0], tw[k, 1]
            assert torch.equal(wf[:n, :L], c) and torch.equal(wf[n:, :L], s)
            assert torch.equal(wf[:n, L:], -s) and torch.equal(wf[n:, L:], c)
            assert torch.equal(wi[:L, :n], c.T / L) and torch.equal(wi[L:, n:], c.T / L)
