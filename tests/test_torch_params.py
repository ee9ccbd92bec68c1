"""PyTorch port vs the JAX package: configuration, precision tiers, units,
frequency plans, dispersion, phase matching and the parameter carry-over.

Both packages get the same float64 inputs, drawn from a seeded numpy
generator.  This is host parameter math in IEEE float64 on both sides, so
agreement is held to rtol 1e-14 (a few ulp: libm ``pow`` and summation
order may differ by one rounding)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu import config as jconfig  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import fwm4 as jfwm4  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.utils import units as junits  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import config as tconfig  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import interop  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils import precision as tprec  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils import units as tunits  # noqa: E402

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden" / "golden_scalars.json").read_text())
RTOL = 1e-14


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _lambdas(n=17, seed=0):
    return np.sort(np.random.default_rng(seed).uniform(1530e-9, 1650e-9, n))


# ---------------------------------------------------------------------------
# config / precision / units
# ---------------------------------------------------------------------------

def test_simulation_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.SimulationConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.SimulationConfig)]
    assert tf == jf
    for name in ("VALID_INTEGRATORS", "MULTISTEP_INTEGRATORS", "SSFM_INTEGRATORS",
                 "ADAPTIVE_INTEGRATORS"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    assert dataclasses.asdict(T.default_simulation_config()) == dataclasses.asdict(
        J.default_simulation_config())
    kw = dict(z_max=2.0, dz=0.01, save_every=5, integrator="abm4", precision="df32")
    assert dataclasses.asdict(T.custom_simulation_config(**kw)) == dataclasses.asdict(
        J.custom_simulation_config(**kw))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(z_max=-1.0, dz=1e-3),
        dict(z_max=1.0, dz=0.0),
        dict(z_max=1.0, dz=2.0),
        dict(z_max=1.0, dz=1e-3, integrator="euler"),
        dict(z_max=1.0, dz=1e-3, save_every=0),
        dict(z_max=1.0, dz=1e-3, precision="float16"),
        dict(z_max=1.0, dz=1e-3, integrator="rk45", rtol=0.0),
    ],
)
def test_validate_config_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError):
        J.validate_config(J.custom_simulation_config(**kwargs))
    with pytest.raises(ValueError):
        T.validate_config(T.custom_simulation_config(**kwargs))


def test_ode_guards_match():
    for integ in ("ab4", "abm4", "rk4ip", "rk4ip45"):
        cfg_j = J.custom_simulation_config(z_max=1.0, dz=0.1, integrator=integ)
        cfg_t = T.custom_simulation_config(z_max=1.0, dz=0.1, integrator=integ)
        for guard in ("reject_multistep", "reject_non_ode"):
            try:
                getattr(jconfig, guard)(cfg_j, "x")
                raised_j = False
            except ValueError:
                raised_j = True
            try:
                getattr(tconfig, guard)(cfg_t, "x")
                raised_t = False
            except ValueError:
                raised_t = True
            assert raised_t == raised_j, (integ, guard)


def test_precision_tier_map():
    """df32 runs natively in float64 on the port; x32 is float32."""
    assert tprec.dtypes_for("x64") == (torch.float64, torch.complex128)
    assert tprec.dtypes_for("df32") == (torch.float64, torch.complex128)
    assert tprec.dtypes_for("x32") == (torch.float32, torch.complex64)
    with pytest.raises(ValueError):
        tprec.dtypes_for("fp16")


def test_units_match():
    for name in ("D_ps_nm_km_to_SI", "S_ps_nm2_km_to_SI", "dSdlmbd_ps_nm3_km_to_SI",
                 "alpha_db_per_km_to_1_m", "omega_from_lambda_scalar"):
        assert getattr(tunits, name)(1.37e-6 if "lambda" in name else 0.37) == getattr(
            junits, name)(1.37e-6 if "lambda" in name else 0.37)
    assert tunits.length_scale_to_m("km") == junits.length_scale_to_m("km")
    with pytest.raises(ValueError):
        tunits.length_scale_to_m("miles")


# ---------------------------------------------------------------------------
# frequency plan
# ---------------------------------------------------------------------------

def test_frequency_plan_matches_jax():
    lam3 = _lambdas()
    om_t = _np(T.plan_from_wavelengths(1550e-9, 1555e-9, lam3))
    om_j = _np(J.plan_from_wavelengths(1550e-9, 1555e-9, lam3))
    np.testing.assert_allclose(om_t, om_j, rtol=RTOL, atol=0)
    sp_t = T.infer_symmetry_from_omegas(*om_t.T)
    sp_j = J.infer_symmetry_from_omegas(*om_j.T)
    for f in ("omega_c", "omega_d", "Omega"):
        np.testing.assert_allclose(_np(getattr(sp_t, f)), _np(getattr(sp_j, f)), rtol=RTOL)
    np.testing.assert_allclose(_np(sp_t.omegas()), _np(sp_j.omegas()), rtol=RTOL)
    np.testing.assert_allclose(_np(T.lambda_from_omega(om_t)), _np(J.lambda_from_omega(om_j)),
                               rtol=RTOL)
    assert T.describe_plan(om_t[0]) == J.describe_plan(om_j[0])


def test_frequency_plan_golden_and_errors():
    om = _np(T.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    np.testing.assert_allclose(om, GOLDEN["plan_1550_1560_1555_omegas"], rtol=1e-15)
    sp = T.infer_symmetry_from_omegas(*om)
    g = GOLDEN["plan_symmetric"]
    assert float(sp.omega_c) == pytest.approx(g["omega_c"], rel=1e-15)
    assert float(sp.omega_d) == pytest.approx(g["omega_d"], rel=1e-12)
    assert float(sp.Omega) == pytest.approx(g["Omega"], rel=1e-12)
    bad = np.array([1.0e15, 1.1e15, 1.05e15, 1.06e15])
    with pytest.raises(ValueError, match="Energy conservation"):
        J.enforce_energy_conservation(bad)
    with pytest.raises(ValueError, match="Energy conservation"):
        T.enforce_energy_conservation(bad)


# ---------------------------------------------------------------------------
# dispersion and phase matching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compat", [False, True])
def test_dispersion_matches_jax(compat):
    rng = np.random.default_rng(1)
    lc, oc = GOLDEN["lambda_c"], GOLDEN["plan_symmetric"]["omega_c"]
    om = _np(J.plan_from_wavelengths(1550e-9, 1560e-9, _lambdas(seed=2)))
    for D, S, dS in rng.uniform([-2.0, 0.0, 0.0], [2.0, 0.1, 1.0], size=(3, 3)):
        kw = dict(lambda_ref_m=lc, D=D, S=S, dSdlmbd=dS, D_units="ps/nm/km",
                  S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km", omega_ref=oc,
                  compat_reference_beta4_bug=compat)
        dt, dj = T.dispersion_params_from_D_S(**kw), J.dispersion_params_from_D_S(**kw)
        np.testing.assert_array_equal(_np(dt.coeffs), _np(dj.coeffs))
        assert float(dt.omega_ref) == float(dj.omega_ref)
        np.testing.assert_allclose(_np(T.beta_taylor(om, dt)), _np(J.beta_taylor(om, dj)),
                                   rtol=RTOL)
        np.testing.assert_allclose(_np(T.delta_beta_from_omegas(om, dt)),
                                   _np(J.delta_beta_from_omegas(om, dj)), rtol=RTOL)
        sp_t, sp_j = T.infer_symmetry_from_omegas(*om.T), J.infer_symmetry_from_omegas(*om.T)
        np.testing.assert_allclose(
            _np(T.delta_beta_symmetric(sp_t.omega_c, sp_t.omega_d, sp_t.Omega, dt)),
            _np(J.delta_beta_symmetric(sp_j.omega_c, sp_j.omega_d, sp_j.Omega, dj)),
            rtol=RTOL)
        np.testing.assert_array_equal(_np(dt.scaled(1000.0).coeffs),
                                      _np(dj.scaled(1000.0).coeffs))


@pytest.mark.parametrize("case", GOLDEN["dispersion_from_D_S"])
def test_dispersion_golden_scalars(case):
    lc, oc = GOLDEN["lambda_c"], GOLDEN["plan_symmetric"]["omega_c"]
    d = T.dispersion_params_from_D_S(
        lambda_ref_m=lc, D=case["D"], S=case["S"], dSdlmbd=case["dSdlmbd"],
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=oc, compat_reference_beta4_bug=True,
    )
    for n in (2, 3, 4):
        assert float(getattr(d, f"beta{n}")) == pytest.approx(case[f"beta{n}"], rel=1e-15)


def test_beta_and_mismatch_golden_scalars():
    lc = GOLDEN["lambda_c"]
    assert T.beta2_from_D(lc, 2e-8) == pytest.approx(GOLDEN["beta2_from_D"], rel=1e-15)
    assert T.beta3_from_D_S(lc, 2e-8, 20.0) == pytest.approx(GOLDEN["beta3_from_D_S"], rel=1e-15)
    assert T.beta4_from_D_S(lc, 2e-8, 20.0, 5e11) == pytest.approx(
        GOLDEN["beta4_from_D_S"], rel=1e-15)
    case = GOLDEN["dispersion_from_D_S"][1]
    d = T.DispersionParams.from_betas(GOLDEN["plan_symmetric"]["omega_c"], beta2=case["beta2"],
                                      beta3=case["beta3"], beta4=case["beta4"])
    np.testing.assert_allclose(_np(T.beta_taylor(GOLDEN["beta_taylor_omegas"], d)),
                               GOLDEN["beta_taylor_values"], rtol=1e-12)
    om = GOLDEN["plan_1550_1560_1555_omegas"]
    assert float(T.delta_beta_from_omegas(om, d)) == pytest.approx(
        GOLDEN["delta_beta_from_omegas"], rel=1e-12)
    sym = GOLDEN["plan_symmetric"]
    assert float(T.delta_beta_symmetric(sym["omega_c"], sym["omega_d"], sym["Omega"], d)) == \
        pytest.approx(GOLDEN["delta_beta_symmetric_24"], rel=1e-12)
    pm = T.PhaseMatchingConfig(method="general_taylor", max_order=4)
    assert float(T.compute_phase_mismatch(om, d, pm).delta_beta) == pytest.approx(
        GOLDEN["pm_general_taylor"], rel=1e-12)


@pytest.mark.parametrize("method", ["general_taylor", "symmetric_even", "provided"])
def test_phase_matching_matches_jax(method):
    lc, oc = GOLDEN["lambda_c"], GOLDEN["plan_symmetric"]["omega_c"]
    kw = dict(lambda_ref_m=lc, D=0.2, S=0.02, D_units="ps/nm/km", S_units="ps/nm^2/km",
              omega_ref=oc)
    om = _np(J.plan_from_wavelengths(1550e-9, 1560e-9, _lambdas(seed=3)))
    extra = {"provided_delta_beta": np.linspace(-0.1, 0.1, om.shape[0])} \
        if method == "provided" else {}
    rj = J.compute_phase_mismatch(om, J.dispersion_params_from_D_S(**kw),
                                  J.PhaseMatchingConfig(method=method, **extra))
    rt = T.compute_phase_mismatch(om, T.dispersion_params_from_D_S(**kw),
                                  T.PhaseMatchingConfig(method=method, **extra))
    np.testing.assert_allclose(_np(rt.delta_beta), _np(rj.delta_beta), rtol=RTOL, atol=0)
    assert (rt.symmetric is None) == (rj.symmetric is None)


# ---------------------------------------------------------------------------
# parameter carry-over
# ---------------------------------------------------------------------------

def _jax_model_params():
    om = _np(J.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    waves = jfwm4.WavesParams.from_symmetry(*[float(_np(getattr(
        J.infer_symmetry_from_omegas(*om), f))) for f in ("omega_c", "omega_d", "Omega")])
    fiber = jfwm4.FiberParams(
        length_m=1000.0, gamma_W_m=0.0115, alpha_1_m=2e-4,
        dispersion=J.dispersion_params_from_D_S(1.555e-6, 0.2, 0.02, D_units="ps/nm/km",
                                                S_units="ps/nm^2/km"),
        beta_legacy_1_m=np.array([1.0, 2.0, 3.0, 4.5]),
    )
    params = jfwm4.make_model_params(waves=waves, fiber=fiber,
                                     grid=jfwm4.SimulationGrid(dz_m=0.1))
    params.cache.set_phase_mismatch(0.0123)
    return params


def _assert_same(a, b):
    """Field-by-field bit equality between a JAX-package object and its port."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(b):
            _assert_same(getattr(a, f.name), getattr(b, f.name))
    elif b is None or isinstance(b, (str, bool, int, tuple)) or hasattr(b, "value"):
        assert a == b or getattr(a, "value", a) == getattr(b, "value", b)
    else:
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_interop_round_trip():
    rng = np.random.default_rng(4)
    objs = [
        J.custom_simulation_config(z_max=3.0, dz=0.1, integrator="ab4", precision="df32"),
        J.RHSCoeffs(gamma=rng.uniform(0, 1, 5), alpha=rng.uniform(0, 1, 5),
                    delta_beta=rng.uniform(-1, 1, 5)),
        J.dispersion_params_from_D_S(1.55e-6, 0.2, 0.02, 0.5, D_units="ps/nm/km",
                                     S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km"),
        J.PhaseMatchingConfig(method="provided", provided_delta_beta=0.25),
        _jax_model_params(),
    ]
    for obj in objs:
        port = interop.from_reference(obj, device="cpu")
        _assert_same(port, obj)
    coeffs = interop.from_reference(objs[1], dtype=torch.float32, device="cpu")
    assert coeffs.gamma.dtype == torch.float32
    with pytest.raises(TypeError):
        interop.from_reference(np.zeros(3), device="cpu")
