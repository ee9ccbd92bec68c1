"""Plain PyTorch reference of the cascaded four-wave-mixing comb: N lines on a
uniform frequency grid obey

    dA_j/dz = (-alpha/2 + i beta_j) A_j + i gamma T_j,
    T_j = sum_{k + l - m = j} A_k A_l A_m^*   (0 <= k, l, m < N),

with ``beta_j`` from the Taylor terms of the dispersion, the constant and
group-delay terms removed (a gauge that leaves every power unchanged).

The cubic sum is evaluated directly, as a plain check of the program's FFT
coupling: ``T_j = sum_m A_m^* Q_{j+m}`` with ``Q_s = sum_{k+l=s} A_k A_l``,
the same products regrouped by ``s = k + l``, gathered by index and summed;
no transform.  Written from the equations, independent of the port; it
runs on any device (the card for the benchmark's check, the CPU in tests).
"""

from __future__ import annotations

import numpy as np
import torch


def beta_lines(n_lines: int, d_omega: float, beta2: float, beta3: float) -> np.ndarray:
    """``beta_j - beta_0 - beta_1 (w_j - w_c)`` [1/m] of the lines ``w_j =
    w_c + (j - N//2) d_omega``: ``beta2 dw^2 / 2 + beta3 dw^3 / 6``."""
    dw = (np.arange(n_lines) - n_lines // 2) * float(d_omega)
    return beta2 * dw ** 2 / 2.0 + beta3 * dw ** 3 / 6.0


class DirectSum:
    """The index tables of the direct cubic sum for N lines on ``device``."""

    def __init__(self, n_lines: int, device):
        n = int(n_lines)
        s = torch.arange(2 * n - 1, device=device)[:, None]
        k = torch.arange(n, device=device)[None, :]
        m = s - k                                  # Q_s: the partner l = s - k
        self.q_valid = (m >= 0) & (m < n)
        self.q_index = m.clamp(0, n - 1)
        j = torch.arange(n, device=device)[:, None]
        self.t_index = j + k                       # T_j: Q_{j+m}, m in [0, N)

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        partner = a[:, self.q_index] * self.q_valid        # (B, 2N-1, N): A_l
        q = (a[:, None, :] * partner).sum(-1)              # (B, 2N-1)
        return (q[:, self.t_index] * a.conj()[:, None, :]).sum(-1)


def rk4(A0, gamma, alpha: float, beta, *, dz: float, n_steps: int, save_every: int,
        dtype=torch.float64, device="cpu"):
    """Fixed-step RK4 of ``(B, N)`` combs: ``(P_max (B, N), P_end (B, N), ok
    (B,))`` as host float64 arrays, the running maximum of each line's power
    over the saved samples (the initial state and every ``save_every``-th
    step), the power at the last saved step, and whether every step stayed
    finite."""
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    y = torch.as_tensor(np.asarray(A0), device=device).to(cdt)
    n = y.shape[1]
    g = torch.as_tensor(np.asarray(gamma, dtype=np.float64), device=device).to(dtype)[:, None]
    lin = torch.complex(torch.full((n,), -0.5 * float(alpha), dtype=dtype),
                        torch.as_tensor(np.asarray(beta, dtype=np.float64)).to(dtype))
    lin = lin.to(device)[None, :]
    ig = torch.complex(torch.zeros_like(g), g)
    cubic = DirectSum(n, device)

    def f(a):
        return lin * a + ig * cubic(a)

    h = float(dz)
    pmax = y.real ** 2 + y.imag ** 2
    p_end = pmax.clone()
    ok = torch.ones(y.shape[0], dtype=torch.bool, device=device)
    for step in range(1, int(n_steps) + 1):
        k1 = f(y)
        k2 = f(y + (0.5 * h) * k1)
        k3 = f(y + (0.5 * h) * k2)
        k4 = f(y + h * k3)
        y_new = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        ok &= torch.isfinite(torch.view_as_real(y_new)).all(-1).all(-1)
        y = torch.where(ok[:, None], y_new, y)
        if step % save_every == 0:
            p_end = y.real ** 2 + y.imag ** 2
            pmax = torch.maximum(pmax, p_end)
    return (pmax.double().cpu().numpy(), p_end.double().cpu().numpy(), ok.cpu().numpy())
