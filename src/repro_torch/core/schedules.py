"""Step-size and β_t schedules, including the theory-driven choices of
Corollaries 1-3 (counterpart of ``repro/core/schedules.py``).

A schedule is ``t -> γ_t`` for a step ``t`` given as an int or an integer
tensor; the decaying ones return a 0-d (or ``t``-shaped) fp32 tensor, as the
reference returns an fp32 array.
"""
from __future__ import annotations

import math

import torch


def constant(gamma):
    return lambda t: gamma


def inv_sqrt(gamma0, warmup=0):
    def f(t):
        t = torch.clamp(torch.as_tensor(t), min=1)
        g = gamma0 / torch.sqrt(t.to(torch.float32))
        if warmup:
            g = torch.where(t < warmup, gamma0 * t / warmup, g)
        return g
    return f


def cosine(gamma0, total, floor=0.0):
    def f(t):
        frac = torch.clamp(torch.as_tensor(t) / total, 0.0, 1.0)
        return floor + 0.5 * (gamma0 - floor) * (1 + torch.cos(math.pi * frac))
    return f


def corollary1_beta(rule: str, gamma, mu, alpha, Gamma):
    """β_{t+1} lower bound from Corollary 1 that keeps the D-drift within
    (1 + γμ/2Γ): rule (2) -> 1 - γμα²/Γ³ ; rule (3) -> 1 - γμα/4Γ²."""
    if rule == "squared":
        return max(0.0, 1.0 - gamma * mu * alpha**2 / Gamma**3)
    return max(0.0, 1.0 - gamma * mu * alpha / (4.0 * Gamma**2))
