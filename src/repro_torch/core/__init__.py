"""SAVIC — the paper's contribution: Local SGD with adaptivity via scaling.

    PrecondConfig, SavicConfig — configuration
    engine.*                   — the round engine (ClientLoop × SyncStrategy ×
                                 ServerUpdate)
    savic.*, fedopt.*          — Algorithm 1 and the FedOpt baseline of [42]
    theory.*, schedules.*      — Theorem 1/2 predictors; step-size schedules
"""
from repro_torch.core.preconditioner import PrecondConfig  # noqa
from repro_torch.core.engine import (AsyncSpec, CompressionSpec,  # noqa
                                     EngineSpec)
from repro_torch.core.savic import (SavicConfig, build_round_step,  # noqa
                                    init_state)
from repro_torch.core import engine, fedopt, savic, schedules, theory  # noqa
