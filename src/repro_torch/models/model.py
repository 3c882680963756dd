"""Top-level model API (counterpart of ``repro/models/model.py``):
``build(cfg, call)`` -> ``Model`` with ``init``, ``loss`` and ``logits``.

Batches are ``{"tokens": (B,S) int, "labels": (B,S) int}``. ``loss`` returns
the mean next-token cross entropy. Prefill and decode come with the serving
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import (AttnCall, cross_entropy, embed,
                                       init_embed, init_rmsnorm, rmsnorm,
                                       unembed)


@dataclasses.dataclass
class ModelCallConfig:
    """Runtime (non-parameter) knobs."""
    dtype: Any = torch.bfloat16
    attn_chunk: int = 1024          # KV chunk for S > dense_attn_max
    dense_attn_max: int = 2048      # dense attention for S <= this
    remat: bool = True
    use_flash_kernel: bool = False
    softcap: float = 0.0


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    call: ModelCallConfig
    init: Callable            # (generator) -> params on generator.device
    loss: Callable            # (params, batch) -> scalar fp32
    logits: Callable          # (params, batch) -> fp32 logits (B, S, V)


def build(cfg: ModelConfig, call: Optional[ModelCallConfig] = None) -> Model:
    call = call or ModelCallConfig()
    dtype = call.dtype

    def init(gen: torch.Generator):
        """Random params from ``gen`` (on its device). The draws differ from
        the reference's ``jax.random`` ones; tests carry weights across with
        ``repro_torch.bridge`` instead of comparing inits."""
        return {"embed": init_embed(gen, cfg),
                "blocks": T.init_stack(gen, cfg),
                "final_norm": init_rmsnorm(cfg.d_model, gen.device)}

    def _attncall(S):
        chunk = call.attn_chunk if S > call.dense_attn_max else 0
        return AttnCall(window=0, softcap=call.softcap, chunk=chunk,
                        use_flash_kernel=call.use_flash_kernel)

    def _forward_logits(params, batch):
        x = embed(params["embed"], batch["tokens"], dtype)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        y = T.forward(params["blocks"], cfg, x, positions, _attncall(S),
                      dtype, remat=call.remat)
        y = rmsnorm(params["final_norm"], y, cfg.norm_eps)
        return unembed(params["embed"], y, cfg, dtype), batch["labels"]

    def loss(params, batch):
        logits_, labels = _forward_logits(params, batch)
        return cross_entropy(logits_, labels, cfg.vocab_size)

    def logits(params, batch):
        return _forward_logits(params, batch)[0].float()

    return Model(cfg=cfg, call=call, init=init, loss=loss, logits=logits)
