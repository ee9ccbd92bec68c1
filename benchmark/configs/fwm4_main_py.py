"""Driver of the ``fwm4_main_py`` configuration: the 4-wave gain spectrum
through the port's ``parallel.sweep.gain_spectrum``.

Traffic keys (``benchmark/traffic/<mix>.json``):

- ``wavelengths``: the signal wavelengths of one call;
- ``integrator`` (``rk4``, ``rk45``) and ``precision``;
- ``input_sets``: the draws made at set-up, cycled through in the window;
  each jitters the band's even grid by up to half its step;
- ``sample_per_set``: the instances of each draw whose answers are kept
  from every job and held to the reference, drawn from the seed;
- ``limit_gain_gap_db``: the limit of the widest gain gap, in dB.
"""

from __future__ import annotations

import numpy as np

from benchmark.cells import SampledCell, port
from benchmark.reference import fwm4 as ref
from benchmark.reference.compare import sample_rows


# the most by which a draw moves a wavelength off the band's even grid, as a
# share of its step
JITTER = 0.5


def build(config: dict, traffic: dict, seed: int, env):
    return Fwm4Cell(config, traffic, seed, env)


def _input_sets(config: dict, traffic: dict, rng):
    """``[wavelengths [m] (Nl,)]``: each a jittered copy of the band's even
    grid; every draw has the same size."""
    ph = config["physics"]
    lo, hi = ph["signal_band_nm"]
    nl = int(traffic["wavelengths"])
    grid = np.linspace(lo, hi, nl)
    step = (hi - lo) / max(nl - 1, 1)
    out = []
    for _ in range(int(traffic["input_sets"])):
        out.append((grid + rng.uniform(-1, 1, nl) * JITTER * step) * 1e-9)
    return out


class Fwm4Cell(SampledCell):
    gap = "gain"
    limit_key = "limit_gain_gap_db"

    def __init__(self, config: dict, traffic: dict, seed: int, env):
        super().__init__(traffic, env)
        self.sweep = port(".parallel.sweep")
        pm = port(".ops.phase_matching")
        self.ph = ph = config["physics"]
        rng = np.random.default_rng(seed)
        self.sets = _input_sets(config, traffic, rng)
        self.instances_per_job = len(self.sets[0])
        self.sample = [sample_rows(rng, self.instances_per_job, int(traffic["sample_per_set"]),
                                   env.chips) for _ in self.sets]
        self.cfg = port().custom_simulation_config(
            z_max=ph["z_max_m"], dz=ph["dz_m"], integrator=traffic["integrator"],
            save_every=ph["save_every"], precision=traffic.get("precision", ph["precision"]),
            rtol=ph["rtol"], atol=ph["atol"], max_steps=ph["max_steps"])
        self.lam1, self.lam2 = ph["lambda_p1_nm"] * 1e-9, ph["lambda_p2_nm"] * 1e-9
        # the dispersion of main_gain_spectrum, expanded at the pumps' centre
        _, _, self.disp = pm.dispersion_at_pump_center(
            self.lam1, self.lam2, float(self.sets[0][0]), D=ph["D_ps_nm_km"],
            S=ph["S_ps_nm2_km"])
        self.pm_cfg = pm.PhaseMatchingConfig(
            method=pm.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=tuple(ph["even_orders"]),
            max_order=4, atol=0.0, rtol=1e-12)
        self.gamma = ph["gamma_per_W_km"] / 1000.0
        self.alpha = port(".utils.units").alpha_db_per_km_to_1_m(ph["alpha_dB_per_km"])

    def job(self, k: int):
        """One ``gain_spectrum`` call on draw ``k``: ``(gain dB, ok)`` over
        the wavelengths, as host arrays."""
        ph = self.ph
        res = self.sweep.gain_spectrum(
            cfg=self.cfg, lambda_p1_m=self.lam1, lambda_p2_m=self.lam2,
            lambda_signal_m=self.sets[self.draw(k)], gamma=self.gamma, alpha=self.alpha,
            p_in=(ph["p_pump_W"], ph["p_pump_W"], ph["p_signal_W"], ph["p_idler_W"]),
            dispersion=self.disp, phase_matching_cfg=self.pm_cfg, length_unit="m",
            gain_unit="dB", gain_mode=ph["gain_mode"], mesh=self.mesh,
            device=None if self.mesh is not None else self.device)
        return np.ravel(res.gain), np.ravel(res.ok)

    def failed(self, answer) -> int:
        return int(np.count_nonzero(~answer[1]))

    def compared(self, answer, idx):
        return answer[0][idx].copy(), answer[1][idx].copy()

    def reference(self, draws, device=None, dtype=np.float64):
        """The plain reference over the listed draws' sampled instances, on
        the host, in one call (the adaptive loop's cost is its iterations,
        not its lanes): ``[(gain dB, ok)]`` a draw."""
        ph = self.ph
        rows = [self.sets[s][self.sample[s]] for s in draws]
        lam = np.concatenate(rows)
        p = np.full(len(lam), ph["p_pump_W"])
        dbeta, valid = ref.delta_beta(self.lam1, self.lam2, lam, ph["D_ps_nm_km"],
                                      ph["S_ps_nm2_km"])
        P0 = np.stack([p, p, np.full_like(p, ph["p_signal_W"]),
                       np.full_like(p, ph["p_idler_W"])], axis=1)
        A0 = np.sqrt(P0).astype(np.complex128)
        g, a = np.full(len(p), self.gamma), np.full(len(p), self.alpha)
        kw = dict(dz=ph["dz_m"], n_steps=int(round(ph["z_max_m"] / ph["dz_m"])),
                  save_every=ph["save_every"], dtype=dtype)
        if self.traffic["integrator"] == "rk45":
            pmax, ok, _attempts = ref.dp45(A0, g, a, dbeta, rtol=ph["rtol"], atol=ph["atol"],
                                           max_steps=ph["max_steps"], **kw)
        else:
            pmax, ok = ref.rk4(A0, g, a, dbeta, **kw)
        ok = ok & valid
        gain = ref.gain_db(pmax[:, 2], ph["p_signal_W"], ok)
        edges = np.cumsum([0] + [len(r) for r in rows])
        return [(gain[i:j], ok[i:j]) for i, j in zip(edges[:-1], edges[1:])]
