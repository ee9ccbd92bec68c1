"""Ready-made experiments wiring the full stack, and their default physics.

Counterpart of the JAX package's ``experiments`` package, with the same
names, defaults and file names (reference ``main.py``:
``main_single_simulation`` :22-117, ``main_gain_spectrum`` :119-203,
``main_gain_spectrum_dbeta`` :206-280), plus the mismatch scan, PSA phase
sweep, 2-D gain map, the comb / Kerr-cavity / pulse / SBS family
experiments and the Monte-Carlo ones (the quantum-noise experiments of
``noise.py`` and the fiber-yield ``gain_ripple``) and the calibration
``fit_gain``.  Each takes ``device`` (``None``: the CUDA card) and forwards
it to every solve; the command line (``__main__.py``) reaches them all.
"""

from ._shared import _PM_DEFAULT, _dispersion_at_pump_center  # noqa: F401
from .comb import comb  # noqa: F401
from .fwm4 import (  # noqa: F401
    gain_map,
    gain_spectrum,
    gain_spectrum_dbeta,
    mismatch_scan,
    psa_phase_sweep,
    single_simulation,
)
from .fitting import fit_gain  # noqa: F401
from .fluctuations import gain_ripple  # noqa: F401
from .lle import kerr_cavity  # noqa: F401
from .noise import (  # noqa: F401
    mi_sideband_noise,
    noise_figure,
    soliton_jitter,
    soliton_link,
    soliton_squeezing,
    squeezing,
)
from .pulses import (  # noqa: F401
    _SC_BETAS_PS_KM,
    gnlse_pulse,
    supercontinuum,
    vector_pulse,
    vector_supercontinuum,
)
from .sbs import fwm_sbs  # noqa: F401

__all__ = [
    "single_simulation", "gain_spectrum", "gain_spectrum_dbeta",
    "mismatch_scan", "psa_phase_sweep", "gain_map", "comb", "kerr_cavity",
    "gnlse_pulse", "vector_pulse", "supercontinuum", "vector_supercontinuum",
    "noise_figure", "fwm_sbs", "gain_ripple", "squeezing", "soliton_squeezing",
    "soliton_jitter", "soliton_link", "mi_sideband_noise", "fit_gain",
]
