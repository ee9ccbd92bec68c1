"""What every configuration's driver shares: the port's modules, the mesh of a
cell over several cards, and the bookkeeping of a sampled check.

A driver (``benchmark/configs/<config>.py``) subclasses :class:`SampledCell`
and fills in ``instances_per_job``, ``sets`` (the draws made at set-up),
``sample`` (the instances of each draw held to the reference), ``job``,
``failed``, ``compared`` and ``reference(draws, device)``, which returns
each listed draw's reference values and ok flags.
"""

from __future__ import annotations

import collections
import importlib

from benchmark.reference.compare import Gap

PORT = "psa_simulation_ode_rk_mvp_dispersion_tpu_torch"


def port(module: str = ""):
    """The port's package, or its submodule ``module`` (``".parallel.sweep"``)."""
    return importlib.import_module(PORT + module)


def mesh_for(env):
    """``default_mesh`` over the cell's cards (over CPU slots in the tests);
    None on one card."""
    if env.chips <= 1:
        return None
    return port(".parallel.mesh").default_mesh(
        env.chips, device=None if env.device.type == "cuda" else env.device)


class SampledCell:
    """Jobs cycle through the draws; each job's answers on its draw's sample
    are kept, and after the window every kept answer is held to the
    reference of its draw.  ``gap`` names the compared value (``gain``,
    ``line``) and ``limit_key`` the traffic key of its limit in dB."""

    gap = ""
    limit_key = ""

    def __init__(self, traffic: dict, env):
        self.traffic = traffic
        self.device = env.device
        self.mesh = mesh_for(env)
        self.sets, self.sample = [], []
        self.kept = collections.defaultdict(list)   # draw -> [(values, ok)] a job

    def draw(self, k: int) -> int:
        return k % len(self.sets)

    def keep(self, k: int, answer) -> None:
        s = self.draw(k)
        self.kept[s].append(self.compared(answer, self.sample[s]))

    def release(self) -> None:
        """Drop what holds the cards, before the reference runs."""
        self.mesh = None

    def check(self, device):
        """Every kept answer against the reference of its draw, the draws'
        references computed in one call."""
        gap = Gap()
        draws = sorted(self.kept)
        for s, (ref_values, ref_ok) in zip(draws, self.reference(draws, device)):
            for values, ok in self.kept[s]:
                gap.add(values, ref_values, ok, ref_ok)
        return gap.checks(self.gap, float(self.traffic[self.limit_key]))
