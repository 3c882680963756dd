"""Preconditioners under the paper's unified Assumption 4 (counterpart of
``repro/core/preconditioner.py``).

  rule (2):  (D^t)² = β_t (D^{t-1})² + (1-β_t) (H^t)²   (Adam/RMSProp/AdaGrad)
  rule (3):   D^t   = β_t  D^{t-1}   + (1-β_t)  H^t     (OASIS)
  rule (4):  (D̂)_ii = max{α, |D_ii|}   or   |D_ii| + α

β_t is constant or Adam's debias β_t = (β - β^{t+1}) / (1 - β^{t+1}) with
β₀ = 0 at the first update; AdaGrad accumulates (D² += H²). State is a dict
``{"d": tree, "t": int32}`` where ``d`` stores D² (rule 2, AdaGrad) or D
(rule 3).

The Hutchinson kinds (``oasis``, ``adahessian``) take their stat from
``hutchinson_diag``, whose Rademacher probes come from an rng stream
(``repro_torch.utils.rng``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

KINDS = ("identity", "adam", "rmsprop", "adagrad", "oasis", "adahessian")


@dataclasses.dataclass(frozen=True)
class PrecondConfig:
    kind: str = "adam"
    beta2: float = 0.999
    alpha: float = 1e-8            # rule-(4) floor, the paper's α
    clip: str = "max"              # "max" (eq. 4) | "add"
    # β_t schedule: "const" | "debias" (Adam's (β-β^{t+1})/(1-β^{t+1}))
    beta_schedule: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind}; expected one of {KINDS}")

    @property
    def rule(self) -> str:
        return "linear" if self.kind == "oasis" else "squared"

    @property
    def schedule(self) -> str:
        if self.beta_schedule:
            return self.beta_schedule
        return "debias" if self.kind in ("adam", "adahessian") else "const"

    @property
    def uses_hutchinson(self) -> bool:
        return self.kind in ("oasis", "adahessian")


def init_state(cfg: PrecondConfig, params):
    """D^0 = I (satisfies Assumption 4 with α ≤ 1 ≤ Γ)."""
    dev = tree_leaves(params)[0].device
    t0 = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.kind == "identity":
        return {"t": t0}
    d = tree_map(lambda p: torch.ones(p.shape, dtype=torch.float32,
                                      device=p.device), params)
    return {"d": d, "t": t0}


def beta_t(cfg: PrecondConfig, t):
    """β_{t+1} for the update at 0-based step ``t`` (an int32 tensor of any
    shape), as an fp32 tensor on ``t``'s device; None for AdaGrad."""
    b = cfg.beta2
    if cfg.kind == "adagrad":
        return None  # accumulate
    if cfg.schedule == "const":
        return torch.full(t.shape, b, dtype=torch.float32, device=t.device)
    tt = t.float() + 1.0               # 1-based update index
    return (b - b ** tt) / (1.0 - b ** tt)


def grad_stat(grads):
    """H² for the Adam family: diag(g⊙g) (returned squared)."""
    return tree_map(lambda g: g.float() ** 2, grads)


def hutchinson_diag(loss_fn, params, batch, stream):
    """diag(v ⊙ ∇²f(x) v) with Rademacher v, one probe leaf per parameter
    leaf from ``stream.split(n_leaves)`` (the reference's per-leaf keys).

    The reference takes the Hessian-vector product forward-over-reverse
    (``jax.jvp`` of ``jax.grad``); this takes it reverse-over-reverse: the
    gradient with ``create_graph=True``, then the gradient of ⟨g, v⟩. The two
    agree in exact arithmetic, not bitwise. It runs through the model's
    non-reentrant ``torch.utils.checkpoint``.
    """
    leaves = tree_leaves(params)
    streams = stream.split(len(leaves))
    v = [s.rademacher(p.shape, p.device).to(p.dtype)
         for s, p in zip(streams, leaves)]
    xs = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, xs), batch)
        g = torch.autograd.grad(loss, xs, create_graph=True)
        gv = sum((gi * vi).sum() for gi, vi in zip(g, v))
    hv = torch.autograd.grad(gv, xs)
    del g, gv
    return tree_unflatten(params, [vi.float() * hi.float()
                                   for vi, hi in zip(v, hv)])


def update(cfg: PrecondConfig, state, stat):
    """One D update from a stat tree: H² for rule (2) kinds, H (signed) for
    rule (3)."""
    t = state["t"]
    if cfg.kind == "identity":
        return {"t": t + 1}
    if cfg.kind == "adagrad":
        d = tree_map(lambda d2, h2: d2 + h2, state["d"], stat)
    else:  # rule (2) squared EMA and rule (3) linear EMA share the formula
        b = beta_t(cfg, t)
        d = tree_map(lambda dd, h: b * dd + (1.0 - b) * h, state["d"], stat)
    return {"d": d, "t": t + 1}


def _dhat_leaf(cfg: PrecondConfig, d):
    mag = torch.sqrt(d) if cfg.rule == "squared" or cfg.kind == "adagrad" \
        else torch.abs(d)
    if cfg.clip == "max":
        return torch.clamp_min(mag, cfg.alpha)
    return mag + cfg.alpha


def dhat(cfg: PrecondConfig, state, leaf_of=None):
    """The clipped diagonal D̂ (rule 4), as a tree (or one leaf)."""
    if cfg.kind == "identity":
        return None
    if leaf_of is not None:
        return _dhat_leaf(cfg, leaf_of)
    return tree_map(lambda d: _dhat_leaf(cfg, d), state["d"])


def precondition(cfg: PrecondConfig, state, grads):
    """D̂^{-1} g, the scaled direction of Algorithm 1."""
    if cfg.kind == "identity":
        return grads
    return tree_map(lambda g, d: (g.float() / d).to(g.dtype), grads,
                    dhat(cfg, state))


def bounds(cfg: PrecondConfig, state):
    """(min, max) of D̂ across the tree, the Lemma 1 check (α ≤ · ≤ Γ)."""
    if cfg.kind == "identity":
        one = torch.tensor(1.0)
        return one, one
    leaves = tree_leaves(dhat(cfg, state))
    lo = torch.stack([x.min() for x in leaves]).min()
    hi = torch.stack([x.max() for x in leaves]).max()
    return lo, hi
