"""Driver of the ``comb_baseline5`` configuration: batches of 64-line
cascaded-FWM combs through the port's ``models.nwave.solve_comb_batch``.

Traffic keys (``benchmark/traffic/<mix>.json``):

- ``combs``: the combs of one call; with ``chips`` > 1 the call splits them
  over the cards with ``mesh=default_mesh(chips)``;
- ``integrator`` (``rk4``) and ``precision``;
- ``input_sets``: the draws made at set-up (each comb's gamma in the
  configuration's range and its noise floor's phases), cycled through in
  the window;
- ``sample_per_set``: the combs of each draw whose answers are kept from
  every job and held to the reference, drawn from the seed evenly over the
  cards' shards;
- ``limit_line_gap_db``: the limit of the widest gap of a line's maximum
  and final power, in dB.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.cells import SampledCell, port
from benchmark.reference import comb as ref
from benchmark.reference.compare import db, sample_rows


def build(config: dict, traffic: dict, seed: int, env):
    return CombCell(config, traffic, seed, env)


class CombCell(SampledCell):
    gap = "line"
    limit_key = "limit_line_gap_db"

    def __init__(self, config: dict, traffic: dict, seed: int, env):
        super().__init__(traffic, env)
        self.nw = port(".models.nwave")
        self.ph = ph = config["physics"]
        n = int(ph["n_lines"])
        B = self.instances_per_job = int(traffic["combs"])
        omega_c = 2 * np.pi * ph["center_THz"] * 1e12
        self.d_omega = 2 * np.pi * ph["line_spacing_GHz"] * 1e9
        pumps = [n // 2 + o for o in ph["pump_offsets"]]
        rng = np.random.default_rng(seed)
        g_lo, g_hi = config["gamma_per_W_km"]
        for _ in range(int(traffic["input_sets"])):
            gammas = rng.uniform(g_lo, g_hi, B) / 1000.0
            A0 = np.sqrt(ph["noise_floor_W"]) * np.exp(2j * np.pi * rng.random((B, n)))
            A0[:, pumps] = np.sqrt(ph["p_pump_W"])
            self.sets.append((gammas, A0))
        self.sample = [sample_rows(rng, B, int(traffic["sample_per_set"]), env.chips)
                       for _ in self.sets]
        self.cfg = port().custom_simulation_config(
            z_max=ph["z_max_m"], dz=ph["z_max_m"] / ph["n_steps"], integrator=traffic["integrator"],
            save_every=ph["save_every"], precision=traffic.get("precision", ph["precision"]))
        self.grid = self.nw.CombGrid.centered(omega_c, self.d_omega, n)
        self.disp = port(".ops.dispersion").DispersionParams.from_betas(
            omega_c, beta2=ph["beta2_s2_per_m"], beta3=ph["beta3_s3_per_m"])

    def job(self, k: int):
        """One ``solve_comb_batch`` call on draw ``k``, the coefficients built
        as a user's script builds them: ``(P_max (B, N), A_end (B, N), ok
        (B,))`` host arrays."""
        gammas, A0 = self.sets[self.draw(k)]
        one = self.nw.make_comb_coeffs(self.grid, self.disp, gamma_W_m=1.0,
                                       alpha_1_m=self.ph["alpha_per_m"])
        coeffs = self.nw.NWaveCoeffs(gamma=gammas, alpha=self.ph["alpha_per_m"],
                                     beta_lin=one.beta_lin)
        return self.nw.solve_comb_batch(
            self.cfg, coeffs, A0, length_unit="m", mesh=self.mesh,
            device=None if self.mesh is not None else self.device)

    def failed(self, answer) -> int:
        return int(np.count_nonzero(~np.asarray(answer[2], dtype=bool)))

    def compared(self, answer, idx):
        p_max, a_end, ok = answer
        return (np.stack([db(p_max[idx]), db(np.abs(a_end[idx]) ** 2)], axis=-1),
                np.asarray(ok[idx], dtype=bool))

    def reference(self, draws, device="cpu", dtype=torch.float64):
        """The plain reference over the listed draws' sampled combs on
        ``device``, in one call: ``[(dB of (P_max, P_end) (S, N, 2), ok
        (S,))]`` a draw."""
        ph = self.ph
        idx = [self.sample[s] for s in draws]
        A0 = np.concatenate([self.sets[s][1][i] for s, i in zip(draws, idx)])
        gammas = np.concatenate([self.sets[s][0][i] for s, i in zip(draws, idx)])
        beta = ref.beta_lines(int(ph["n_lines"]), self.d_omega, ph["beta2_s2_per_m"],
                              ph["beta3_s3_per_m"])
        pmax, p_end, ok = ref.rk4(A0, gammas, ph["alpha_per_m"], beta,
                                  dz=ph["z_max_m"] / ph["n_steps"], n_steps=int(ph["n_steps"]),
                                  save_every=int(ph["save_every"]), dtype=dtype, device=device)
        values = np.stack([db(pmax), db(p_end)], axis=-1)
        edges = np.cumsum([0] + [len(i) for i in idx])
        return [(values[i:j], ok[i:j]) for i, j in zip(edges[:-1], edges[1:])]
