"""Architecture configs (counterpart of ``repro/configs/__init__.py``).

The port's own copy of ``MoEConfig``, ``SSMConfig``, ``ModelConfig`` (with
``param_count`` and ``active_param_count``), ``get_config``, ``register``
and ``list_archs``. The dense, moe, ssm and hybrid families' fields are
carried. Registered with the package (each full and ``REDUCED``):
``qwen2-0.5b``, ``qwen3-4b``, ``deepseek-67b`` (dense, llama-arch, GQA
64/8), ``gemma3-4b`` (dense, ``local_global_ratio`` local layers with a
sliding window to one global layer, GeGLU, a tied head scaled by d^-½),
``qwen2-moe-a2.7b`` (moe: 60 routed top-4 experts and a shared MLP in
every layer), ``mamba2-1.3b`` and ``zamba2-2.7b`` (mamba2 layers with one
weight-tied attention + MLP block after every ``hybrid_attn_every``-th),
and, as in the reference's ``_VARIANTS``, ``qwen3-4b-swa``
(``CONFIG_SWA``: a sliding window of 8192). ``register`` adds a module of
the caller's (``examples/train_lm_torch.py`` registers its ``lm-100m``).
The reference's other architectures (MLA, audio, vlm) raise until their
model family is ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    n_shared: int = 0               # always-on shared experts
    top_k: int = 1
    d_ff_expert: int = 0            # per-expert FFN hidden dim
    d_ff_shared: int = 0            # total shared-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_layer_start: int = 0        # first layer index that is MoE (earlier = dense)
    d_ff_dense: int = 0             # FFN dim for the dense (non-MoE) layers


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
    family: str                     # "dense" | "moe" | "ssm" | "hybrid"
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
    # gemma3: N local layers per 1 global (0 = all global)
    local_global_ratio: int = 0
    logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): run a shared (weight-tied) attention block every k
    # ssm layers
    hybrid_attn_every: int = 0
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
        """Analytic parameter count, the reference's formula for the dense,
        moe, ssm and hybrid families (it leaves out the qkv biases, counts
        the hybrid's shared block once, its MLP as 3d², and a MoE layer's
        shared experts as ``n_shared`` MLPs of ``d_ff_shared // n_shared``
        each)."""
        if self.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"family {self.family!r} is not ported to repro_torch yet")
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        n = V * d  # embeddings
        if not self.tie_embeddings:
            n += V * d  # lm head
        per_layer = 0
        hd = self.head_dim
        if self.family == "ssm" or (self.family == "hybrid" and self.ssm):
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # in_proj(z,x,B,C,dt) + conv + out_proj + A,D,dt_bias + norm
            conv_dim = d_in + 2 * s.ngroups * s.d_state
            per_layer += d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads)
            per_layer += conv_dim * s.d_conv + d_in * d + 3 * nheads + 2 * d
        if self.family in ("dense", "moe") or self.hybrid_attn_every:
            attn = d * self.n_heads * hd  # q
            attn += 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            if self.hybrid_attn_every:  # weight-tied shared block counted once
                n += attn + 3 * d * d  # incl. shared MLP-ish projections
            per_layer += attn if not self.hybrid_attn_every else 0
        if self.family == "dense":
            per_layer += 3 * d * self.d_ff + 2 * d
        elif self.family == "moe":
            m = self.moe
            moe_layers = L - m.moe_layer_start
            n += moe_layers * (m.n_experts * 3 * d * m.d_ff_expert
                               + m.n_shared * 3 * d
                               * (m.d_ff_shared // max(m.n_shared, 1))
                               + d * m.n_experts)  # router
            n += m.moe_layer_start * 3 * d * (m.d_ff_dense or self.d_ff)
            per_layer += 2 * d  # norms
        n += per_layer * L + d  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: the routed top-k only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        moe_layers = self.n_layers - m.moe_layer_start
        unused = (moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model
                  * m.d_ff_expert)
        return self.param_count() - unused


_MODULE_FOR = {"zamba2-2.7b": "zamba2_2p7b", "qwen3-4b": "qwen3_4b",
               "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
               "gemma3-4b": "gemma3_4b", "qwen2-0.5b": "qwen2_0p5b",
               "deepseek-67b": "deepseek_67b", "mamba2-1.3b": "mamba2_1p3b"}
# beyond-assignment variants (selectable, as in the reference)
_VARIANTS = {"qwen3-4b-swa": ("qwen3_4b", "CONFIG_SWA")}


def register(arch_id: str, module_name: str) -> None:
    """Make ``arch_id`` name the module ``repro_torch.configs.<module_name>``
    (its ``CONFIG`` and ``REDUCED``); the caller may put that module into
    ``sys.modules`` itself."""
    _MODULE_FOR[arch_id] = module_name


def list_archs():
    return list(_MODULE_FOR)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    """Look up a ported or registered architecture (or a variant of one) by
    its dashed id."""
    if arch in _VARIANTS:
        modname, attr = _VARIANTS[arch]
        mod = importlib.import_module(f"repro_torch.configs.{modname}")
        return mod.REDUCED if reduced else getattr(mod, attr)
    if arch not in _MODULE_FOR:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{sorted(_MODULE_FOR) + sorted(_VARIANTS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
