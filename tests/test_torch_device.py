"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: with no card and no ``device``, each raises instead of falling back
to the CPU.  ``torch.cuda.is_available`` is patched to return False, so the
tests behave the same on a machine with a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import interop  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils.checks import resolve_device  # noqa: E402

_PM = dict(phase_matching_cfg=T.PhaseMatchingConfig(method="provided", provided_delta_beta=0.0))
_DISP = T.dispersion_params_from_D_S(1.5525e-6, 0.2, 0.02, D_units="ps/nm/km",
                                     S_units="ps/nm^2/km")
_CFG = T.custom_simulation_config(z_max=1.0, dz=0.1)
_SPECTRUM = dict(cfg=_CFG, lambda_p1_m=1550e-9, lambda_p2_m=1555e-9,
                 lambda_signal_m=[1560e-9, 1565e-9], gamma=0.0115, alpha=0.0,
                 p_in=[0.5, 0.5, 1e-7, 1e-7], dispersion=_DISP)
_COEFFS = T.RHSCoeffs(np.full(2, 0.01), np.zeros(2), np.zeros(2))
_A0 = np.full((2, 4), 0.1, dtype=np.complex128)
_COMB = T.NWaveCoeffs(gamma=0.01, alpha=0.0, beta_lin=np.zeros(5))
_COMB_A0 = np.full((2, 5), 0.1, dtype=np.complex128)
_PULSE = T.GNLSECoeffs(gamma=0.01, alpha=0.0, lin_phase=np.zeros(128))
_PULSE_A0 = np.full((2, 128), 0.1, dtype=np.complex128)
_CAVITY = T.LLECoeffs(detuning=1.0, pump_re=1.0, pump_im=0.0, lin_phase=np.zeros(128))
_CAVITY_A0 = np.full((2, 128), 0.1, dtype=np.complex128)
_LLE_GRID = T.TimeGrid(n_samples=128, t_window_s=20.0)
_VECTOR = T.VGNLSECoeffs(gamma=0.01, alpha=0.0, b_xpm=1.0, lin_phase=np.zeros((2, 128)))
_VECTOR_A0 = np.full((2, 2, 128), 0.1, dtype=np.complex128)

ENTRY_POINTS = {
    "solve_batch": lambda **d: T.solve_batch(_CFG, _COEFFS, _A0, **d),
    "solve_batch_rk45": lambda **d: T.solve_batch(
        T.custom_simulation_config(z_max=1.0, dz=0.1, integrator="rk45"), _COEFFS, _A0, **d),
    "solve_batch_trajectories": lambda **d: T.solve_batch_trajectories(_CFG, _COEFFS, _A0, **d),
    "gain_spectrum": lambda **d: T.gain_spectrum(**_SPECTRUM, **d),
    "gain_and_dbeta_spectrum": lambda **d: T.gain_and_dbeta_spectrum(**_SPECTRUM, **d),
    "dbeta_spectrum": lambda **d: T.dbeta_spectrum(
        lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=[1560e-9],
        dispersion=_DISP, **d),
    "mismatch_scan": lambda **d: T.mismatch_scan(
        cfg=_CFG, gamma=10.0, alpha=0.0, p_in=[0.1, 0.1, 1e-4, 0.0],
        delta_beta_values=[0.0, 1.0], length_unit="m", **d),
    "psa_phase_sweep": lambda **d: T.psa_phase_sweep(
        cfg=_CFG, gamma=10.0, alpha=0.0, p_in=[0.1, 0.1, 1e-4, 1e-4],
        signal_phases=[0.0, 1.0], **d),
    "gain_map_power_wavelength": lambda **d: T.gain_map_power_wavelength(
        cfg=_CFG, lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=[1560e-9],
        pump_powers_W=[0.1, 0.2], gamma=0.0115, alpha=0.0, dispersion=_DISP, **d),
    "run_single_simulation": lambda **d: T.run_single_simulation(
        _CFG, gamma=0.01, alpha=0.0, omega=np.full(4, 1.2e15), p_in=[0.1, 0.1, 1e-6, 0.0],
        **_PM, **d),
    "example_zero_signal": lambda **d: T.example_zero_signal(**d),
    "lower_params": lambda **d: T.lower_params(_MODEL_PARAMS, **d),
    "run_adaptive_trajectory": lambda **d: T.run_adaptive_trajectory(
        T.custom_simulation_config(z_max=1.0, dz=0.1, integrator="rk45"), _MODEL_PARAMS,
        T.RHSCoeffs(0.01, 0.0, 0.0), np.full(4, 0.1, dtype=np.complex128), frame="rotating",
        length_unit="m", return_length_unit=None, **d),
    "solve_comb_batch": lambda **d: T.nwave.solve_comb_batch(_CFG, _COMB, _COMB_A0, **d),
    "solve_comb_batch_rk45": lambda **d: T.nwave.solve_comb_batch(
        T.custom_simulation_config(z_max=1.0, dz=0.1, integrator="rk45"), _COMB, _COMB_A0, **d),
    "run_comb_simulation": lambda **d: T.run_comb_simulation(_CFG, _COMB, _COMB_A0[0], **d),
    "solve_comb_batch_trajectories": lambda **d: T.nwave.solve_comb_batch_trajectories(
        _CFG, _COMB, _COMB_A0, **d),
    "solve_gnlse_batch": lambda **d: T.solve_gnlse_batch(_CFG, _PULSE, _PULSE_A0, **d),
    "solve_gnlse_batch_rk45": lambda **d: T.solve_gnlse_batch(
        T.custom_simulation_config(z_max=1.0, dz=0.1, integrator="rk45"), _PULSE, _PULSE_A0, **d),
    "run_gnlse_simulation": lambda **d: T.run_gnlse_simulation(_CFG, _PULSE, _PULSE_A0[0], **d),
    "solve_gnlse_batch_trajectories": lambda **d: T.gnlse.solve_gnlse_batch_trajectories(
        _CFG, _PULSE, _PULSE_A0, **d),
    "solve_lle_batch": lambda **d: T.solve_lle_batch(_CFG, _CAVITY, _CAVITY_A0, **d),
    "solve_lle_batch_rk45": lambda **d: T.solve_lle_batch(
        T.custom_simulation_config(z_max=1.0, dz=0.1, integrator="rk45"), _CAVITY, _CAVITY_A0,
        **d),
    "run_lle_simulation": lambda **d: T.run_lle_simulation(_CFG, _CAVITY, _CAVITY_A0[0], **d),
    "solve_lle_batch_trajectories": lambda **d: T.lle.solve_lle_batch_trajectories(
        _CFG, _CAVITY, _CAVITY_A0, **d),
    "run_lle_ramp": lambda **d: T.run_lle_ramp(_CFG, _CAVITY, _CAVITY_A0[0], detuning_start=0.0,
                                               detuning_end=1.0, **d),
    "detuning_scan": lambda **d: T.detuning_scan(_CFG, _LLE_GRID, detunings=[0.5, 1.0],
                                                 pump=1.0, d2=-1.0, **d),
    "solve_vgnlse_batch": lambda **d: T.solve_vgnlse_batch(_CFG, _VECTOR, _VECTOR_A0, **d),
    "solve_vgnlse_batch_rk45": lambda **d: T.solve_vgnlse_batch(
        T.custom_simulation_config(z_max=1.0, dz=0.1, integrator="rk45"), _VECTOR, _VECTOR_A0,
        **d),
    "run_vgnlse_simulation": lambda **d: T.run_vgnlse_simulation(_CFG, _VECTOR, _VECTOR_A0[0],
                                                                 **d),
    "solve_vgnlse_batch_trajectories": lambda **d: T.solve_vgnlse_batch_trajectories(
        _CFG, _VECTOR, _VECTOR_A0, **d),
    "from_reference": lambda **d: interop.from_reference(
        J.RHSCoeffs(gamma=np.ones(2), alpha=np.zeros(2), delta_beta=np.zeros(2)), **d),
}

_MODEL_PARAMS = T.make_model_params(
    waves=T.WavesParams(omega=np.full(4, 1.2e15)),
    fiber=T.FiberParams(length_m=1.0, gamma_W_m=0.01, beta_legacy_1_m=np.zeros(4)),
    grid=T.SimulationGrid(dz_m=0.1),
)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_when_there_is_no_card(no_card, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", ["solve_batch", "gain_spectrum", "lower_params",
                                  "run_adaptive_trajectory", "from_reference", "dbeta_spectrum",
                                  "solve_comb_batch", "run_comb_simulation",
                                  "solve_gnlse_batch", "run_gnlse_simulation",
                                  "solve_gnlse_batch_trajectories", "solve_lle_batch",
                                  "solve_lle_batch_rk45", "run_lle_simulation",
                                  "solve_lle_batch_trajectories", "run_lle_ramp",
                                  "detuning_scan", "solve_vgnlse_batch",
                                  "solve_vgnlse_batch_rk45", "run_vgnlse_simulation",
                                  "solve_vgnlse_batch_trajectories"])
def test_entry_point_runs_on_the_cpu_when_asked(no_card, name):
    assert ENTRY_POINTS[name](device="cpu") is not None


def test_resolver(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)


def test_resolver_picks_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_from_reference_carries_the_gnlse_parameters():
    """A JAX ``TimeGrid``, ``GNLSECoeffs`` (spectral alpha) and ``NLTerms``
    arrive as equal float64 values; the grid stays a host container."""
    jgrid = J.TimeGrid.for_pulse(1e-12, n_samples=128)
    om = jgrid.omega()
    jc = J.make_gnlse_coeffs(jgrid, J.DispersionParams.from_betas(1.2e15, beta2=-2e-26),
                             gamma_W_m=2e-3, alpha_1_m=5e-5,
                             alpha_spec_1_m=1e-4 * (om / om.max()) ** 2)
    jnl = J.make_nl_terms(jgrid, f_raman=0.18, omega0=1.2e15)
    grid = interop.from_reference(jgrid, device="cpu")
    assert isinstance(grid, T.TimeGrid) and grid == T.TimeGrid(128, jgrid.t_window_s)
    for obj, cls in ((jc, T.GNLSECoeffs), (jnl, T.NLTerms)):
        got = interop.from_reference(obj, device="cpu")
        assert isinstance(got, cls)
        for f in ("gamma", "alpha", "lin_phase") if cls is T.GNLSECoeffs else (
                "f_r", "inv_w0", "omega", "hr_re", "hr_im"):
            v = getattr(got, f)
            assert v.dtype == torch.float64
            assert np.array_equal(v.numpy(), np.asarray(getattr(obj, f)))


def test_from_reference_carries_the_lle_parameters():
    """A JAX ``LLECoeffs`` (complex pump, per-cavity detuning) arrives as
    equal float64 tensors, an ``LLENormalization`` as a host container of
    floats."""
    jc = J.make_lle_coeffs(J.lle.TimeGrid(n_samples=128, t_window_s=20.0),
                           detuning=np.linspace(1.0, 4.0, 3), pump=2.0 * np.exp(0.3j), d2=-1.0)
    got = interop.from_reference(jc, device="cpu")
    assert isinstance(got, T.LLECoeffs)
    for f in ("detuning", "pump_re", "pump_im", "lin_phase"):
        v = getattr(got, f)
        assert v.dtype == torch.float64 and np.array_equal(v.numpy(), np.asarray(getattr(jc, f)))
    jn = J.normalize_ring_cavity(round_trip_length_m=100.0, t_roundtrip_s=5e-7, gamma_W_m=1.2e-3,
                                 beta2_s2_m=-21e-27, alpha_half_loss=0.1, coupling_theta=0.08,
                                 detuning_phase_rad=0.3, pump_power_W=1.5)
    tn = interop.from_reference(jn, device="cpu")
    assert isinstance(tn, T.LLENormalization) and tn == T.normalize_ring_cavity(
        round_trip_length_m=100.0, t_roundtrip_s=5e-7, gamma_W_m=1.2e-3, beta2_s2_m=-21e-27,
        alpha_half_loss=0.1, coupling_theta=0.08, detuning_phase_rad=0.3, pump_power_W=1.5)
