"""SAVIC — the paper's contribution: Local SGD with adaptivity via scaling.

    PrecondConfig, SavicConfig — configuration
    engine.*                   — the round engine (ClientLoop × SyncStrategy ×
                                 ServerUpdate)
    savic.*, fedopt.*          — Algorithm 1 and the FedOpt baseline of [42]
"""
from repro_torch.core.preconditioner import PrecondConfig  # noqa
from repro_torch.core.engine import EngineSpec  # noqa
from repro_torch.core.savic import SavicConfig  # noqa
from repro_torch.core import engine, fedopt, savic  # noqa
