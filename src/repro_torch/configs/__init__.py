"""Architecture configs (counterpart of ``repro/configs/__init__.py``).

The port's own copy of ``ModelConfig`` and ``get_config``. Only the dense
family's fields are carried, and only ``qwen2-0.5b`` (full and ``REDUCED``) is
registered; the reference's other architectures raise until their model
family is ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_MODULE_FOR = {"qwen2-0.5b": "qwen2_0p5b"}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    """Look up a ported architecture by its dashed id."""
    if arch not in _MODULE_FOR:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
