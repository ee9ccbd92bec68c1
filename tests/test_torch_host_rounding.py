"""The port's pulse noise statistics against the JAX package run at another
vector ISA, on the CPU.

XLA's CPU code rounds by the host's vector instruction set (SSE4.2, AVX,
AVX2, AVX-512), torch's does not, so the JAX reference does not reproduce
itself from one host to the next in the figures that are small sums of
large terms.  A subprocess runs the JAX functions of the cases that showed
it with ``--xla_cpu_max_isa=SSE4_2`` appended to the ``XLA_FLAGS`` of the
root ``conftest.py`` and pickles their results; the port's results,
computed here, are held to them with ``test_torch_noise.compare``.  The
in-process JAX holds of ``test_torch_pulse_noise.py`` run at the host's
own ISA, so every run of the suite holds the port to two ISA levels.

Run as a script (``python tests/test_torch_host_rounding.py OUT.pkl``) it
writes the JAX package's results of ``CASES`` to ``OUT.pkl`` at whatever
``XLA_FLAGS`` it is given.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_tpu as J  # noqa: E402
import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import noise as JN  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import noise as TN  # noqa: E402
from test_torch_noise import compare  # noqa: E402
from test_torch_pulse_noise import OM0, pulse_setup  # noqa: E402

HERE = Path(__file__).resolve().parent
ISA_FLAG = "--xla_cpu_max_isa=SSE4_2"

# name -> (function, pulse_setup arguments, function arguments): the cases of
# test_torch_pulse_noise.py whose figures moved with the host's ISA
CASES = {
    "squeezing-mean-output": ("pulse_squeezing_monte_carlo", {},
                              dict(n_samples=32, seed=0, lo_mode="mean-output")),
    "photon-statistics": ("pulse_photon_statistics", {}, dict(n_samples=32, seed=4)),
    "photon-statistics-mask": ("pulse_photon_statistics", {},
                               dict(n_samples=32, seed=4,
                                    filter_mask=np.exp(-np.fft.fftfreq(128) ** 2 * 50))),
    "squeezing-spectrum": ("pulse_squeezing_spectrum", dict(cw=True, periods=2.0),
                           dict(n_samples=32, seed=6, return_coherence=False)),
    "squeezing-spectrum-coherence": ("pulse_squeezing_spectrum", dict(cw=True, periods=2.0),
                                     dict(n_samples=32, seed=6, return_coherence=True)),
}


def run_cases(P, mod, **extra):
    """Every case of ``CASES`` through package ``P``'s noise module ``mod``."""
    out = {}
    for name, (fn, setup_kw, kw) in CASES.items():
        grid, co, A0, cfg = pulse_setup(P, **setup_kw)
        out[name] = getattr(mod, fn)(cfg, co, A0, grid, omega0=OM0, **kw, **extra)
    return out


@pytest.fixture(scope="module")
def jax_at_sse42(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_rounding") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {ISA_FLAG}".strip(),
               PYTHONPATH=os.pathsep.join(filter(None, [str(HERE.parent),
                                                        os.environ.get("PYTHONPATH")])))
    subprocess.run([sys.executable, __file__, str(out)], env=env, cwd=HERE.parent,
                   check=True, timeout=300)
    with open(out, "rb") as fh:
        flags, results = pickle.load(fh)
    assert flags.split()[-1] == ISA_FLAG
    assert "xla_force_host_platform_device_count=8" in flags
    return results


@pytest.fixture(scope="module")
def port():
    return run_cases(T, TN, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_at_sse42(case, jax_at_sse42, port):
    compare(port[case], jax_at_sse42[case])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")  # as the root conftest.py, whatever plugin loads
    with open(sys.argv[1], "wb") as fh:
        pickle.dump((os.environ.get("XLA_FLAGS", ""), run_cases(J, JN)), fh)
