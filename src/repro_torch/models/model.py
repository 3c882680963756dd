"""Top-level model API (counterpart of ``repro/models/model.py``):
``build(cfg, call)`` -> ``Model`` with ``init``, ``loss``, ``logits``, and
the serving functions ``prefill``, ``init_cache``, ``prefill_cache``,
``decode``, ``decode_sample`` and ``sample_head``.

Batches are ``{"tokens": (B,S) int, "labels": (B,S) int}``. ``loss`` returns
the mean next-token cross entropy plus the MoE router's load-balance loss
(summed over the layers; 0 for the other families); ``logits`` and the
prefills drop it, as the reference's do. The decode cache is the one of
``transformer.init_decode_cache``; decode steps update it in place.
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
    decode_window: int = 0          # ring-buffer decode cache of this size
    use_decode_kernel: bool = False  # K5 decode attention + K6 sampling
    softcap: float = 0.0
    use_ssd_kernel: bool = False    # ssm/hybrid: the SSD on K7 (forward only)
    exact_moe: bool = False         # no MoE capacity drops (C = tokens·K)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    call: ModelCallConfig
    init: Callable            # (generator) -> params on generator.device
    loss: Callable            # (params, batch) -> scalar fp32
    logits: Callable          # (params, batch) -> fp32 logits (B, S, V)
    # (params, batch) -> (last-position logits (B,V), raw stacked caches)
    prefill: Callable = None
    # (batch, cache_len, device) -> empty decode cache
    init_cache: Callable = None
    # (params, batch, cache_len) -> (last-position logits, decode cache at
    # pos = S): prefill whose cache feeds decode directly, no prompt replay
    prefill_cache: Callable = None
    # (params, cache, token (B,), pos) -> (logits (B,V), cache)
    decode: Callable = None
    # (params, cache, token, pos, noise (B,V), head=None) -> (next token (B,)
    # int32, cache): one decode step fused with Gumbel-argmax sampling
    decode_sample: Callable = None
    # (params) -> (table (V,d) contiguous fp32, scale): K6's unembed operand,
    # made once per call site and passed to decode_sample as ``head``
    sample_head: Callable = None


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
                        use_flash_kernel=call.use_flash_kernel,
                        force_window=call.decode_window,
                        use_ssd_kernel=call.use_ssd_kernel,
                        exact_moe=call.exact_moe)

    def _forward(params, tokens, want_cache, remat):
        x = embed(params["embed"], tokens, dtype)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        return T.forward(params["blocks"], cfg, x, positions, _attncall(S),
                         dtype, want_cache=want_cache, remat=remat)

    def _forward_logits(params, batch):
        y, _, aux = _forward(params, batch["tokens"], False, call.remat)
        y = rmsnorm(params["final_norm"], y, cfg.norm_eps)
        return unembed(params["embed"], y, cfg, dtype), batch["labels"], aux

    def loss(params, batch):
        logits_, labels, aux = _forward_logits(params, batch)
        return cross_entropy(logits_, labels, cfg.vocab_size) + aux

    def logits(params, batch):
        return _forward_logits(params, batch)[0].float()

    def _last_logits(params, y):
        y = rmsnorm(params["final_norm"], y[:, -1:, :], cfg.norm_eps)
        return unembed(params["embed"], y, cfg, dtype)[:, 0, :]

    def prefill(params, batch):
        y, caches, _ = _forward(params, batch["tokens"], True, False)
        return _last_logits(params, y), caches

    def init_cache(batch_size, cache_len, device):
        clen = min(cache_len, call.decode_window) if call.decode_window \
            else cache_len
        return T.init_decode_cache(cfg, batch_size, clen, device)

    def prefill_cache(params, batch, cache_len):
        """Prefill returning (last-position logits, decode-ready cache).

        Unlike ``prefill`` (whose cache is the raw stacked per-layer
        output), the cache here is in ``init_cache`` layout, populated so
        decode continues at pos = prompt_len: no prompt replay."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        y, caches, _ = _forward(params, tokens, True, False)
        cache = T.prefill_to_decode_cache(
            cfg, caches, S, init_cache(B, cache_len, tokens.device))
        return _last_logits(params, y), cache

    def _decode_hidden(params, cache, token, pos):
        x = embed(params["embed"], token[:, None], dtype)
        call_d = AttnCall(window=call.decode_window or 0,
                          softcap=call.softcap,
                          force_window=call.decode_window,
                          use_decode_kernel=call.use_decode_kernel,
                          exact_moe=call.exact_moe)
        y, cache = T.decode(params["blocks"], cfg, x, pos, cache, call_d,
                            dtype)
        return rmsnorm(params["final_norm"], y, cfg.norm_eps), cache

    def decode(params, cache, token, pos):
        """token (B,) int ids; pos an int or (B,) per-slot positions.
        Returns (logits (B,V), cache)."""
        y, cache = _decode_hidden(params, cache, token, pos)
        return unembed(params["embed"], y, cfg, dtype)[:, 0, :], cache

    def sample_head(params):
        if cfg.tie_embeddings:
            return params["embed"]["table"].float().contiguous(), \
                cfg.d_model ** -0.5
        return params["embed"]["head"].float().T.contiguous(), 1.0

    def decode_sample(params, cache, token, pos, noise, head=None):
        """One decode step fused with sampling: next token = argmax over the
        real vocab of logits + ``noise`` ((B,V) fp32; zeros = greedy, Gumbel
        draws = categorical). With ``use_decode_kernel`` the unembed and the
        argmax run in one pass of kernel K6 without writing the logits;
        ``head`` is ``sample_head(params)``, made once by the caller (for an
        untied head it is a (V, d) copy)."""
        y, cache = _decode_hidden(params, cache, token, pos)
        y = y[:, 0, :]
        if call.use_decode_kernel:
            from repro_torch.kernels import ops as kops
            table, scale = head if head is not None else sample_head(params)
            tok = kops.decode_sample(y.float().contiguous(), table,
                                     noise.float().contiguous(), scale=scale,
                                     v_real=cfg.vocab_size)
        else:
            lg = unembed(params["embed"], y[:, None, :], cfg, dtype)[:, 0]
            tok = sample_ids(lg, noise, cfg.vocab_size)
        return tok, cache

    return Model(cfg=cfg, call=call, init=init, loss=loss, logits=logits,
                 prefill=prefill, init_cache=init_cache,
                 prefill_cache=prefill_cache, decode=decode,
                 decode_sample=decode_sample, sample_head=sample_head)


def sample_ids(logits, noise, vocab_size):
    """Token ids (B,) int32: the first argmax over the real vocabulary
    (ids < ``vocab_size``) of fp32 ``logits`` + ``noise``."""
    lg = logits.float() + noise
    V = lg.shape[-1]
    if V > vocab_size:
        lg = lg.masked_fill(torch.arange(V, device=lg.device) >= vocab_size,
                            float("-inf"))
    return torch.argmax(lg, dim=-1).to(torch.int32)


# --------------------------------------------------------------------------- #
# input specs (token families)
# --------------------------------------------------------------------------- #

# one fold constant per batch field; the reference folds hash(name), which
# Python salts per process
_FIELD_FOLD = {"tokens": 1, "labels": 2}


def batch_struct(cfg: ModelConfig, batch: int, seq: int):
    """(shape, dtype) of each field of a training/prefill batch."""
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}


def sample_batch(cfg: ModelConfig, stream, batch: int, seq: int, device):
    """A random batch matching ``batch_struct``: ids uniform in
    [0, vocab_size), each field drawn from ``stream.fold(<its constant>)``."""
    out = {}
    for name, (shape, _) in batch_struct(cfg, batch, seq).items():
        u = stream.fold(_FIELD_FOLD[name]).uniform(shape, device)
        ids = (u * cfg.vocab_size).floor_().to(torch.int32)
        out[name] = ids.clamp_(max=cfg.vocab_size - 1)
    return out
