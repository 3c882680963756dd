"""FedOpt baseline — Algorithm 2 of Reddi et al. [42]: FedAdaGrad / FedAdam /
FedYogi (counterpart of ``repro/core/fedopt.py``).

Clients run K plain local SGD steps from x_t; the server treats
Δ_t = mean_m (x_{m,K} - x_t) as a pseudo-gradient:

    m_t = β₁ m_{t-1} + (1-β₁) Δ_t
    v_t = v_{t-1} + Δ_t²                              (FedAdaGrad)
    v_t = β₂ v_{t-1} + (1-β₂) Δ_t²                    (FedAdam)
    v_t = v_{t-1} - (1-β₂) Δ_t² sign(v_{t-1}-Δ_t²)    (FedYogi)
    x_{t+1} = x_t + η m_t / (√v_t + τ)

A thin method definition over ``core/engine.py`` that keeps the reference's
single-replica state layout ``{"params", "m", "v", "round"}``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import engine
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class FedOptConfig:
    server_opt: str = "adam"       # adagrad | adam | yogi
    eta: float = 0.1               # server lr η
    eta_l: float = 0.05            # client lr η_l
    beta1: float = 0.9
    beta2: float = 0.999
    tau: float = 1e-3              # adaptivity floor τ
    v_init: float = None           # v_{-1}; default τ²
    client_momentum: float = 0.0
    local_steps: tuple = None      # per-client H_m (None = uniform)
    participation: float = 1.0     # fraction of clients in the sync average
    # sync delta compression; its EF residual needs the engine's per-client
    # state, which this single-replica layout has no slot for
    compression: engine.CompressionSpec = engine.CompressionSpec()
    use_fused_kernel: bool = False # fused client loop and K3


def engine_spec(cfg: FedOptConfig) -> engine.EngineSpec:
    """FedOptConfig -> the engine's three-layer spec. The fused fast path
    also runs int8 compression on its kernel (K3), as
    ``engine.method_spec`` sets it."""
    comp = cfg.compression
    if comp.error_feedback and not comp.is_identity():
        raise ValueError("FedOpt's single-replica state has no EF residual; "
                         "use engine.method_spec for compression with EF")
    if cfg.use_fused_kernel and not comp.use_fused_kernel:
        comp = dataclasses.replace(comp, use_fused_kernel=True)
    spec = engine.method_spec(
        "fed" + cfg.server_opt, eta=cfg.eta, eta_l=cfg.eta_l, tau=cfg.tau,
        server_beta1=cfg.beta1, server_beta2=cfg.beta2, v_init=cfg.v_init,
        local_steps=cfg.local_steps, participation=cfg.participation,
        compression=comp, use_fused_kernel=cfg.use_fused_kernel)
    if cfg.client_momentum:
        spec = dataclasses.replace(spec, client=dataclasses.replace(
            spec.client, momentum=cfg.client_momentum))
    return spec


def init_state(generator, init_params_fn, cfg: FedOptConfig):
    params = init_params_fn(generator)
    v0 = cfg.v_init if cfg.v_init is not None else cfg.tau ** 2
    dev = tree_leaves(params)[0].device
    return {"params": params,
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(lambda p: torch.full_like(p, v0), params),
            "round": torch.zeros((), dtype=torch.int32, device=dev)}


def build_round_step(loss_fn: Callable, cfg: FedOptConfig):
    """Returns ``round_step(state, batch, stream=None)``; batch leaves
    (M, K, ...)."""
    eng_step = engine.build_round_step(loss_fn, engine_spec(cfg))

    def round_step(state, batch, stream=None):
        M = tree_leaves(batch)[0].shape[0]
        params_m = tree_map(lambda p: engine._replicate(p, M),
                            state["params"])
        eng_state = {
            "params": params_m,
            "mom": tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                  device=p.device), params_m),
            "precond": {"t": state["round"]},
            "server": {"m": state["m"], "v": state["v"]},
            "round": state["round"],
        }
        eng_state, met = eng_step(eng_state, batch, stream)
        new_state = {"params": engine.average_params(eng_state),
                     "m": eng_state["server"]["m"],
                     "v": eng_state["server"]["v"],
                     "round": eng_state["round"]}
        return new_state, {"loss": met["loss"], "step_norm": met["step_norm"]}

    return round_step
