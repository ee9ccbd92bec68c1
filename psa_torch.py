"""Short import alias: ``import psa_torch`` -> the PyTorch port package."""
import sys

import psa_simulation_ode_rk_mvp_dispersion_tpu_torch as _pkg

sys.modules[__name__] = _pkg
