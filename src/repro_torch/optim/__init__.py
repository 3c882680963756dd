"""Plain inner optimizers (counterpart of ``repro/optim``)."""
from repro_torch.optim.inner import adamw_step, sgd_step

__all__ = ["adamw_step", "sgd_step"]
