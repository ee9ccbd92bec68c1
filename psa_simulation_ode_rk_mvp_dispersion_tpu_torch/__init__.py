"""psa_simulation_ode_rk_mvp_dispersion_tpu_torch -- the PyTorch / CUDA port
of the four-wave-mixing / phase-sensitive-amplifier framework.

The JAX package ``psa_simulation_ode_rk_mvp_dispersion_tpu`` is the
reference; this package keeps its module paths and public names, so each
function's counterpart is found by name.  This slice covers the main path:
parameter math, the 4-wave RHS, fixed-step integrators, the single-run
runner and the gain-spectrum sweep, whose rotating-frame solve runs on a
CUDA device through a hand-written kernel (``ops/cuda_solver.py``,
``csrc/fwm4_rk.cu``).

Precision tiers: ``x64`` and ``df32`` run in float64/complex128, ``x32`` in
float32/complex64.  Public entry points take ``device=``; ``None`` means
``torch.get_default_device()``.

Import alias: ``import psa_torch`` (see repo-root ``psa_torch.py``).
"""

from __future__ import annotations

from . import constants, interop
from .config import (
    SimulationConfig,
    custom_simulation_config,
    default_simulation_config,
    validate_config,
)
from .ops import analytic, cuda_solver, dispersion, frequency_plan, integrators, phase_matching, rhs
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
from .models import fwm4
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
    SweepResult,
    dbeta_spectrum,
    gain_and_dbeta_spectrum,
    gain_spectrum,
    solve_batch,
)

__version__ = "0.1.0"
