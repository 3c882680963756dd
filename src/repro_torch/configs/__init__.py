"""Architecture configs (counterpart of ``repro/configs/__init__.py``).

The port's own copy of ``MoEConfig``, ``SSMConfig``, ``ModelConfig`` (with
``param_count`` and ``active_param_count``), ``get_config``, ``register``
and ``list_archs``. The dense, moe, ssm and hybrid families' fields are
carried. Registered with the package (each full and ``REDUCED``):
``qwen2-0.5b``, ``qwen3-4b``, ``deepseek-67b`` (dense, llama-arch, GQA
64/8), ``gemma3-4b`` (dense, ``local_global_ratio`` local layers with a
sliding window to one global layer, GeGLU, a tied head scaled by d^-½),
``qwen2-moe-a2.7b`` (moe: 60 routed top-4 experts and a shared MLP in
every layer), ``deepseek-v2-236b`` (moe with multi-head latent attention,
``MLAConfig``: 160 routed top-6 experts, two shared, one dense prefix
layer), ``mamba2-1.3b`` and ``zamba2-2.7b`` (mamba2 layers with one
weight-tied attention + MLP block after every ``hybrid_attn_every``-th),
``musicgen-large`` (audio: frame embeddings replace the token embeddings)
and ``internvl2-1b`` (vlm: ``frontend_tokens`` patch embeddings prepended
to the text), and, as in the reference's ``_VARIANTS``, ``qwen3-4b-swa``
(``CONFIG_SWA``: a sliding window of 8192). Beside them, as variants (no
counterpart in the reference, so neither in ``ARCH_IDS`` nor in
``list_archs()``): ``nemotron3-nano-30b-a3b`` (family ``nemotron_h``: a
``layer_pattern`` of Mamba-2 layers at 8 groups, sigmoid-routed relu²
expert layers and attention without positions) and
``nemotron3-nano-30b-a3b-ep16``, one chip's share of it (8 of each layer's
128 experts held, 32,768 of the 131,072 ids). ``register`` adds a module of
the caller's (``examples/train_lm_torch.py`` registers its ``lm-100m``).
Every architecture of the reference's registry has its counterpart.

The input shapes (``ShapeConfig``, ``INPUT_SHAPES``, ``get_shape``) are
the reference's, field for field, and so are ``ARCH_IDS``,
``LONG_CONTEXT_ARCHS`` and ``pairs_to_run()`` (the dry run's 34 pairs). ``param_shapes(cfg)`` gives a model's
parameter tree as ``meta`` tensors (shapes and dtypes, no storage), so the
partitioner can read a full-size tree (deepseek-v2-236b is 878 GiB in
fp32) without allocating it.
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
    # nemotron_h's expert share: the picks' sigmoid scores, normalised, times
    # this (models/moe.route_sigmoid)
    routed_scale: float = 1.0
    # the expert share (nemotron_h): experts [first_held, first_held +
    # n_held) are held here (0: all), every choice on them computed
    n_held: int = 0
    first_held: int = 0


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                # SSD chunk length
    ngroups: int = 1
    n_heads: int = 0                # 0: expand·d_model / head_dim
    conv_bias: bool = False         # a bias on the depthwise conv's x, B, C


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
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
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU) | relu2
    rope: bool = True               # False: attention without positions
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): run a shared (weight-tied) attention block every k
    # ssm layers
    hybrid_attn_every: int = 0
    # modality frontend stub: extra embedding inputs (B, n_frontend, d_model)
    frontend_tokens: int = 0        # vlm: #patch embeddings; audio: -1 (1:1)
    frontend_kind: str = ""         # "" | "vision" | "audio"
    # nemotron_h: layer i is the kind of letter i (M mamba2, E the expert
    # share, * attention), each kind's leaves stacked apart
    layer_pattern: str = ""
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def layer_kinds(self) -> str:
        """The pattern's letters of the ``n_layers`` layers ("" without a
        pattern)."""
        if len(self.layer_pattern) < self.n_layers and self.layer_pattern:
            raise ValueError(f"{self.name}: {self.n_layers} layers, a "
                             f"pattern of {len(self.layer_pattern)}")
        return self.layer_pattern[:self.n_layers]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula (it leaves out
        the qkv biases and MLA's two RMSNorm scales, counts the hybrid's
        shared block once, its MLP as 3d², a MoE layer's shared experts as
        ``n_shared`` MLPs of ``d_ff_shared // n_shared`` each, and the
        audio and vlm families as dense stacks: their frontends are
        stubs)."""
        if self.layer_pattern:
            return self._pattern_param_count()
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
        if self.family in ("dense", "moe", "audio", "vlm") \
                or self.hybrid_attn_every:
            if self.mla:
                m = self.mla
                attn = (d * m.q_lora_rank
                        + m.q_lora_rank * self.n_heads
                        * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * self.n_heads
                        * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
            else:
                attn = d * self.n_heads * hd  # q
                attn += 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            if self.hybrid_attn_every:  # weight-tied shared block counted once
                n += attn + 3 * d * d  # incl. shared MLP-ish projections
            per_layer += attn if not self.hybrid_attn_every else 0
        if self.family in ("dense", "audio", "vlm"):
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

    def _pattern_param_count(self) -> int:
        """The pattern stack's tree, leaf for leaf (padded vocabulary aside):
        a mamba2 layer with its conv biases, an expert layer with its
        held experts, shared expert, router and score bias, an attention
        layer, each with its pre-norm; embedding, head and final norm."""
        d, s, m = self.d_model, self.ssm, self.moe
        nh = s.n_heads or s.expand * d // s.head_dim
        d_in, gn = nh * s.head_dim, s.ngroups * s.d_state
        conv = (d_in + 2 * gn) * (s.d_conv + int(s.conv_bias))
        per = {"M": d * (2 * d_in + 2 * gn + nh) + conv + d_in * d
               + 3 * nh + d_in,
               "E": (m.n_held or m.n_experts) * 2 * d * m.d_ff_expert
               + 2 * d * m.d_ff_shared + d * m.n_experts + m.n_experts,
               "*": 2 * d * self.n_heads * self.head_dim
               + 2 * d * self.n_kv_heads * self.head_dim}
        layers = sum(per[k] + d for k in self.layer_kinds)
        head = 1 if self.tie_embeddings else 2
        return head * self.vocab_size * d + layers + d

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: the routed top-k only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        moe_layers = self.n_layers - m.moe_layer_start
        unused = (moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model
                  * m.d_ff_expert)
        return self.param_count() - unused


# the assigned architectures, in the reference's order
ARCH_IDS = ("zamba2-2.7b", "qwen3-4b", "qwen2-moe-a2.7b", "gemma3-4b",
            "qwen2-0.5b", "deepseek-67b", "mamba2-1.3b", "musicgen-large",
            "deepseek-v2-236b", "internvl2-1b")
_MODULE_FOR = {a: a.replace("-", "_").replace(".", "p") for a in ARCH_IDS}
# beyond-assignment variants (selectable, as in the reference)
_VARIANTS = {"qwen3-4b-swa": ("qwen3_4b", "CONFIG_SWA"),
             "nemotron3-nano-30b-a3b": ("nemotron3_nano_30b_a3b", "CONFIG"),
             "nemotron3-nano-30b-a3b-ep16": ("nemotron3_nano_30b_a3b",
                                             "CONFIG_EP16")}


# --------------------------------------------------------------------------- #
# Input shapes (the reference's)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# archs allowed to run long_500k (a decode step that does not grow with
# the context, or a sliding window)
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "gemma3-4b", "qwen3-4b")


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def pairs_to_run():
    """Every (arch, shape) pair of the assignment, in the reference's order:
    each arch of ``ARCH_IDS`` at each shape, ``long_500k`` only for
    ``LONG_CONTEXT_ARCHS``."""
    return [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
            if s != "long_500k" or a in LONG_CONTEXT_ARCHS]


def param_shapes(cfg: ModelConfig):
    """The parameter tree of ``models.build(cfg)`` as ``meta`` tensors:
    the init runs under ``FakeTensorMode``, so nothing is allocated."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import build
    from repro_torch.utils.tree import tree_map
    with FakeTensorMode():
        fake = build(cfg).init(torch.Generator())
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def register(arch_id: str, module_name: str) -> None:
    """Make ``arch_id`` name the module ``repro_torch.configs.<module_name>``
    (its ``CONFIG`` and ``REDUCED``); the caller may put that module into
    ``sys.modules`` itself."""
    _MODULE_FOR[arch_id] = module_name


def list_archs():
    return list(_MODULE_FOR)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    """Look up an architecture config (or a variant of one, or a
    registered id) by its dashed id; an unknown id raises KeyError, as in
    the reference."""
    if arch in _VARIANTS:
        modname, attr = _VARIANTS[arch]
        mod = importlib.import_module(f"repro_torch.configs.{modname}")
        return mod.REDUCED if reduced else getattr(mod, attr)
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULE_FOR) + sorted(_VARIANTS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
