"""Closed-form predictors from the paper's theorems (a copy of
``repro/core/theory.py``, which the port may not import) — used by
``launch/paper.py`` to validate the implementation against the paper's own
claims.

Theorem 1 (identical data, μ>0, γ ≤ α/4L):
    E‖x̂_T − x*‖² = O( (1−γμ/2Γ)^T (Γ/α)‖x₀−x*‖²
                       + γΓσ²/(α²μM) + Lγ²Γ(H−1)σ²/(μα³) )

Theorem 2 (heterogeneous, γ ≤ α/(10(H−1)L)):
    E[f(x̄) − f*] ≤ (1−γμ/2Γ)^T Γ‖x₀−x*‖²/γ + γσ²_dif(9(H−1)/2α + 8/Mα)

These are upper bounds with unspecified constants; the harness fits the
*shape*: (a) geometric contraction factor ≈ (1−γμ/2Γ) during the transient,
(b) noise-ball ∝ γ/M with an additional (H−1)γ² term, (c) α-sensitivity.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    mu: float
    L: float
    sigma2: float          # Assumption-2 variance σ²
    alpha: float           # preconditioner floor
    Gamma: float           # preconditioner cap
    M: int
    H: int

    @property
    def kappa(self):
        return self.L / self.mu

    @property
    def kappa_hat(self):
        return self.L * self.Gamma / (self.mu * self.alpha)


def thm1_rate(spec: ProblemSpec, gamma: float) -> float:
    """Per-step contraction factor of the bias term."""
    return 1.0 - gamma * spec.mu / (2.0 * spec.Gamma)


def thm1_noise_ball(spec: ProblemSpec, gamma: float) -> float:
    """Stationary E‖x̂−x*‖² level (up to the theorem's absolute constants)."""
    a, G = spec.alpha, spec.Gamma
    return (4.0 * G * gamma * spec.sigma2 / (spec.mu * spec.M * a**2)
            + 8.0 * G * gamma**2 * spec.L * (spec.H - 1) * spec.sigma2
            / (spec.mu * a**3))


def thm1_gamma_max(spec: ProblemSpec) -> float:
    return spec.alpha / (4.0 * spec.L)


def thm2_gamma_max(spec: ProblemSpec) -> float:
    return spec.alpha / (10.0 * max(spec.H - 1, 1) * spec.L)


def thm2_bound(spec: ProblemSpec, gamma: float, T: int, r0: float,
               sigma2_dif: float) -> float:
    """Full Theorem-2 right-hand side (f-gap)."""
    a, G = spec.alpha, spec.Gamma
    bias = (1.0 - gamma * spec.mu / (2.0 * G)) ** T * G * r0 / gamma
    noise = gamma * sigma2_dif * (9.0 * (spec.H - 1) / (2.0 * a)
                                  + 8.0 / (spec.M * a))
    return bias + noise


def cor2_params(spec: ProblemSpec, t_extra: float = 1.0):
    """Corollary 2's (γ, T) choice: γ = Γ/(μa), a = 4κ̂ + t, T = 4a·log a."""
    a = 4.0 * spec.kappa_hat + t_extra
    gamma = spec.Gamma / (spec.mu * a)
    T = int(np.ceil(4.0 * a * np.log(max(a, np.e))))
    return gamma, T


def local_sgd_noise_ball(spec: ProblemSpec, gamma: float) -> float:
    """Unscaled Local SGD (Khaled et al. [36]) noise ball — the Γ/α-free
    comparison point the paper's §5.1 discusses."""
    return (4.0 * gamma * spec.sigma2 / (spec.mu * spec.M)
            + 8.0 * gamma**2 * spec.L * (spec.H - 1) * spec.sigma2 / spec.mu)
