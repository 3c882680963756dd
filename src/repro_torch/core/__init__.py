"""SAVIC — the paper's contribution: Local SGD with adaptivity via scaling.

    PrecondConfig, SavicConfig — configuration
    engine.*                   — the round engine (ClientLoop × SyncStrategy ×
                                 ServerUpdate)
    controller.*, objectives.* — the adaptive knob controller; client
                                 objectives
    savic.*, fedopt.*          — Algorithm 1 and the FedOpt baseline of [42]
    theory.*, schedules.*      — Theorem 1/2 predictors; step-size schedules
"""
from repro_torch.core.preconditioner import PrecondConfig  # noqa
from repro_torch.core.controller import ControllerSpec  # noqa
from repro_torch.core.engine import (AsyncSpec, CompressionSpec,  # noqa
                                     EngineSpec)
from repro_torch.core.objectives import ClientObjective, ObjectiveSpec  # noqa
from repro_torch.core.savic import (SavicConfig, build_round_step,  # noqa
                                    init_state)
from repro_torch.core import (controller, engine, fedopt,  # noqa
                              objectives, savic, schedules, theory)
