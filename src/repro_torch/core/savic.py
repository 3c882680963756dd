"""SAVIC — Algorithm 1: Local SGD with preconditioning via scaling
(counterpart of ``repro/core/savic.py``).

A round = H local steps on each of M clients, then one synchronization
(parameter averaging). Under *global scaling* (the analysed setting) D̂ is
updated only at sync and shared by every client; under *local scaling* each
client updates its own D every local step. A thin method definition over
``core/engine.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import engine
from repro_torch.core.preconditioner import PrecondConfig


@dataclasses.dataclass(frozen=True)
class SavicConfig:
    gamma: float = 0.1                 # step size γ
    beta1: float = 0.9                 # heavy-ball momentum
    scaling: str = "global"            # "global" (Algorithm 1) | "local"
    stat_source: str = "avg_grad"      # D-stat at sync: avg_grad | avg_local
    average_momentum: bool = True      # average momentum buffers at sync
    weight_decay: float = 0.0
    grad_clip: float = 0.0             # global-norm clip per local step
    use_fused_kernel: bool = False     # one fused kernel launch per step
    sync_dtype: str = ""               # all-reduce dtype ("" = full)
    participation: float = 1.0
    compression: engine.CompressionSpec = engine.CompressionSpec()
    local_steps: tuple = None
    asynchrony: engine.AsyncSpec = engine.AsyncSpec()


def engine_spec(pc_cfg: PrecondConfig, sv_cfg: SavicConfig) -> engine.EngineSpec:
    """SavicConfig × PrecondConfig -> the engine's three-layer spec. The
    fused fast path also runs int8 compression on its kernel (K3), as
    ``engine.method_spec`` sets it."""
    comp = sv_cfg.compression
    if sv_cfg.use_fused_kernel and not comp.use_fused_kernel:
        comp = dataclasses.replace(comp, use_fused_kernel=True)
    return engine.EngineSpec(
        client=engine.ClientLoopSpec(
            lr=sv_cfg.gamma, momentum=sv_cfg.beta1, scaling=sv_cfg.scaling,
            stat_source=sv_cfg.stat_source, weight_decay=sv_cfg.weight_decay,
            grad_clip=sv_cfg.grad_clip,
            use_fused_kernel=sv_cfg.use_fused_kernel,
            local_steps=sv_cfg.local_steps),
        sync=engine.SyncSpec(
            participation=sv_cfg.participation, sync_dtype=sv_cfg.sync_dtype,
            average_momentum=sv_cfg.average_momentum,
            compression=comp, asynchrony=sv_cfg.asynchrony),
        server=engine.ServerSpec(kind="average"),
        precond=pc_cfg)


def init_state(generator, init_params_fn, pc_cfg: PrecondConfig,
               sv_cfg: SavicConfig, n_clients: int):
    """The SAVIC train state; x_0^m = x_0 (identical start)."""
    return engine.init_state(generator, init_params_fn,
                             engine_spec(pc_cfg, sv_cfg), n_clients)


def build_round_step(loss_fn: Callable, pc_cfg: PrecondConfig,
                     sv_cfg: SavicConfig):
    """Returns ``round_step(state, batch, stream=None)``; batch leaves
    (M, H, ...)."""
    return engine.build_round_step(loss_fn, engine_spec(pc_cfg, sv_cfg))


def average_params(state):
    return engine.average_params(state)
