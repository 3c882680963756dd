"""Architecture configs (counterpart of ``repro/configs/__init__.py``).

The port's own copy of ``SSMConfig``, ``ModelConfig`` (with
``param_count``), ``get_config``, ``register`` and ``list_archs``. Only the
dense and ssm families' fields are carried, and only ``qwen2-0.5b`` and
``mamba2-1.3b`` (each full and ``REDUCED``) are registered with the package;
``register`` adds a module of the caller's (``examples/train_lm_torch.py``
registers its ``lm-100m``). The reference's other architectures (hybrid,
MoE, MLA, audio, vlm) raise until their model family is ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                # SSD chunk length
    ngroups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # "dense" | "ssm" are ported
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
    ssm: Optional[SSMConfig] = None
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula for the dense
        and ssm families (it leaves out the qkv biases)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        n = V * d if self.tie_embeddings else 2 * V * d
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # in_proj (z, x, B, C, dt) + conv + out_proj + A, D, dt_bias
            # + norms
            conv_dim = d_in + 2 * s.ngroups * s.d_state
            per_layer = (d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads)
                         + conv_dim * s.d_conv + d_in * d + 3 * nheads
                         + 2 * d)
        elif self.family == "dense":
            hd = self.head_dim
            per_layer = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                         + self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d)
        else:
            raise NotImplementedError(
                f"family {self.family!r} is not ported to repro_torch yet")
        return n + per_layer * L + d       # + the final norm


_MODULE_FOR = {"qwen2-0.5b": "qwen2_0p5b", "mamba2-1.3b": "mamba2_1p3b"}


def register(arch_id: str, module_name: str) -> None:
    """Make ``arch_id`` name the module ``repro_torch.configs.<module_name>``
    (its ``CONFIG`` and ``REDUCED``); the caller may put that module into
    ``sys.modules`` itself."""
    _MODULE_FOR[arch_id] = module_name


def list_archs():
    return list(_MODULE_FOR)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    """Look up a ported or registered architecture by its dashed id."""
    if arch not in _MODULE_FOR:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
