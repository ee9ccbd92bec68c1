"""psa_simulation_ode_rk_mvp_dispersion_tpu_torch -- the PyTorch / CUDA port
of the four-wave-mixing / phase-sensitive-amplifier framework.

The JAX package ``psa_simulation_ode_rk_mvp_dispersion_tpu`` is the
reference; this package keeps its module paths and public names, so each
function's counterpart is found by name.  The port covers the 4-wave main
path: parameter math, the RHS, the fixed-step (rk4/ab4/abm4) and adaptive
(rk45) integrators, the single-run runner, the sweeps (gain spectrum,
mismatch scan, PSA phase sweep, power x wavelength gain map, batched
trajectories), result persistence (``io_fwm``), the N-wave comb
(``models/nwave``), the GNLSE pulse model (``models/gnlse``), the
Lugiato-Lefever cavity (``models/lle``) and the vector (two-polarization)
GNLSE (``models/vgnlse``).  The rotating-frame sweeps and the batched comb,
pulse, cavity and vector solves run on a CUDA device through hand-written
kernels: ``csrc/fwm4_rk.cu``
(``ops/cuda_solver.py``), ``csrc/fwm4_rk45.cu`` (``ops/cuda_adaptive.py``),
``csrc/comb_rk.cu`` (``ops/cuda_comb.py``), ``csrc/comb_rk45.cu``
(``ops/cuda_comb_adaptive.py``), ``csrc/gnlse_ssfm.cu``
(``ops/cuda_gnlse.py``), ``csrc/lle_ssfm.cu`` (``ops/cuda_lle.py``),
``csrc/ssfm_rk45.cu``
(``ops/cuda_ssfm_adaptive.py``, GNLSE and LLE routes) and
``csrc/vgnlse_ssfm.cu`` (``ops/cuda_vgnlse.py``).

Precision tiers: ``x64`` and ``df32`` run in float64/complex128, ``x32`` in
float32/complex64.  Public entry points take ``device=``; ``None`` means the
CUDA card, and without one they raise (pass ``device='cpu'`` for the CPU).

Import alias: ``import psa_torch`` (see repo-root ``psa_torch.py``).
"""

from __future__ import annotations

from . import constants, interop, io_fwm
from .config import (
    SimulationConfig,
    custom_simulation_config,
    default_simulation_config,
    validate_config,
)
from .ops import (
    adaptive,
    analytic,
    cuda_adaptive,
    cuda_comb,
    cuda_comb_adaptive,
    cuda_gnlse,
    cuda_lle,
    cuda_solver,
    cuda_ssfm_adaptive,
    cuda_vgnlse,
    dispersion,
    frequency_plan,
    integrators,
    phase_matching,
    rhs,
)
from .ops.adaptive import (
    integrate_adaptive_grid,
    integrate_adaptive_reduce,
    rk45_step,
    run_adaptive_trajectory,
)
from .ops.analytic import pia_signal_gain, psa_gain_extrema
from .ops.dispersion import (
    DispersionParams,
    beta2_from_D,
    beta3_from_D_S,
    beta4_from_D_S,
    beta_taylor,
    delta_beta_from_omegas,
    delta_beta_symmetric,
    dispersion_params_from_D_S,
)
from .ops.frequency_plan import (
    SymmetricPlan,
    describe_plan,
    enforce_energy_conservation,
    f_from_omega,
    infer_symmetry_from_omegas,
    lambda_from_omega,
    omega_from_f,
    omega_from_lambda,
    plan_from_omegas,
    plan_from_symmetry,
    plan_from_wavelengths,
)
from .ops.integrators import (
    integrate_fixed_grid,
    integrate_fixed_step,
    integrate_interval,
    integrate_reduce,
    rk4_step,
)
from .ops.phase_matching import (
    PhaseMatchingConfig,
    PhaseMatchingMethod,
    PhaseMatchingResult,
    PhaseMismatchCalculator,
    compute_phase_mismatch,
)
from .ops.rhs import (
    RHSCoeffs,
    kerr_factors,
    make_rhs_yaman,
    rhs_yaman,
    rhs_yaman_autonomous,
    rhs_yaman_simplified,
    rotating_to_lab,
)
from .models import fwm4, gnlse, lle, nwave, vgnlse
from .models.lle import (
    LLECoeffs,
    LLENormalization,
    cw_steady_states,
    detuning_scan,
    make_lle_coeffs,
    normalize_ring_cavity,
    run_lle_ramp,
    run_lle_simulation,
    soliton_ansatz,
    solve_lle_batch,
)
from .models.gnlse import (
    GNLSECoeffs,
    NLTerms,
    TimeGrid,
    gaussian_pulse,
    make_gnlse_coeffs,
    make_nl_terms,
    raman_response,
    raman_t_r,
    run_gnlse_simulation,
    sech_pulse,
    solve_gnlse_batch,
    soliton_peak_power,
)
from .models.vgnlse import (
    MANAKOV_GAMMA_FACTOR,
    XPM_LINEAR_BIREFRINGENT,
    VGNLSECoeffs,
    degree_of_polarization,
    make_vgnlse_coeffs,
    manakov_soliton_peak_power,
    polarized_pulse,
    run_vgnlse_simulation,
    solve_vgnlse_batch,
    solve_vgnlse_batch_trajectories,
    stokes_parameters,
)
from .models.nwave import (
    CombGrid,
    NWaveCoeffs,
    comb_beta_lin,
    make_comb_coeffs,
    rhs_nwave,
    run_comb_simulation,
    seed_comb,
)
from .models.fwm4 import (
    CacheParams,
    FiberParams,
    ModelParams,
    PhaseMatchingParams,
    SimulationGrid,
    WAVE_ORDER,
    WavesParams,
    custom_seeded_signal,
    example_zero_signal,
    lower_params,
    make_default_phase_matching_params,
    make_initial_amplitudes,
    make_model_params,
    run_single_simulation,
)
from .parallel import sweep as sweeps
from .parallel.sweep import (
    BatchSolveResult,
    GainMapResult,
    SweepResult,
    dbeta_spectrum,
    gain_and_dbeta_spectrum,
    gain_map_power_wavelength,
    gain_spectrum,
    mismatch_scan,
    psa_phase_sweep,
    solve_batch,
    solve_batch_trajectories,
)
from .io_fwm import (
    load_gain_map_npz,
    load_metadata_json,
    load_result_npz,
    load_sweep_npz,
    make_run_metadata,
    save_gain_map_npz,
    save_metadata_json,
    save_result_npz,
    save_run_bundle,
    save_summary_csv,
    save_sweep_npz,
)

__version__ = "0.1.0"
