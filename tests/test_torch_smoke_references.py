"""The plain fp64 references ``chip_smoke.py`` stores (``smoke_references.py``)
are of this code's inputs: every stored input equals the one
``chip_smoke.reference_inputs`` builds now, and the references have the
shapes the phases compare against.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import psa_torch as psa  # noqa: E402


@pytest.mark.parametrize("name, shape", [("rk45_gain", (32,)), ("lle_A", (8, chip_smoke.LLE_T))])
def test_stored_reference_is_of_this_run_s_inputs(name, shape):
    ref = chip_smoke.stored_reference(psa, name)
    assert ref.shape == shape
    assert np.isfinite(ref).all()


def test_a_changed_input_is_refused(monkeypatch):
    inputs = chip_smoke.reference_inputs

    def shifted(p):
        got = inputs(p)
        got["rk45_lambda_m"] = got["rk45_lambda_m"] * (1 + 1e-9)
        return got
    monkeypatch.setattr(chip_smoke, "reference_inputs", shifted)
    with pytest.raises(AssertionError, match="rk45_lambda_m is not this run's input"):
        chip_smoke.stored_reference(psa, "rk45_gain")
