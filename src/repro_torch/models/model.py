"""Top-level model API (counterpart of ``repro/models/model.py``):
``build(cfg, call)`` -> ``Model`` with ``init``, ``loss``, ``logits``, and
the serving functions ``prefill``, ``init_cache``, ``prefill_cache``,
``decode``, ``decode_sample`` and ``sample_head``.

Batch formats, as in the reference:

* token families (dense, moe, ssm, hybrid):
  ``{"tokens": (B,S) int, "labels": (B,S) int}``;
* audio (musicgen; the EnCodec frontend is a stub): frame embeddings
  replace the token embeddings 1:1,
  ``{"embeds": (B,S,d) fp32, "labels": (B,S) int}``;
* vlm (internvl2; the ViT and projector are stubs): P patch embeddings
  prepended to the text, ``{"patches": (B,P,d) fp32, "tokens": (B,S-P)
  int, "labels": (B,S-P) int}``; the labels cover the text positions only
  (-1 over the patches).

Decode consumes one token id a sequence in every family. ``loss`` returns
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
from repro_torch.utils import trace


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
    exact_moe: bool = False         # no MoE capacity drops (C = tokens·K)
    mla_absorbed: bool = True       # MLA decode in the latent space
    # optional hook on the (B,S,d) residual input of ``loss``/``logits``,
    # where the reference pins batch-parallel activations on a mesh
    act_shard: Any = None
    # optional hook ``fn(x, where)`` on the MoE's (B,E,C,·) dispatch buffer
    # and its combine outputs (``where`` "dispatch" | "combine")
    moe_shard: Any = None


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
                        exact_moe=call.exact_moe, moe_shard=call.moe_shard)

    def _residual_input(params, batch):
        """The family's residual-stream input (B,S,d) and its labels (None
        where the batch has none)."""
        labels = batch.get("labels")
        if cfg.family == "audio":
            return batch["embeds"].to(dtype), labels
        if cfg.family == "vlm":
            tx = embed(params["embed"], batch["tokens"], dtype)
            patches = batch["patches"]
            x = torch.cat([patches.to(dtype), tx], dim=1)
            if labels is not None:
                pad = torch.full(patches.shape[:2], -1, dtype=labels.dtype,
                                 device=labels.device)
                labels = torch.cat([pad, labels], dim=1)
            return x, labels
        return embed(params["embed"], batch["tokens"], dtype), labels

    def _forward(params, batch, want_cache, remat, constrain=False):
        x, labels = _residual_input(params, batch)
        if constrain and call.act_shard is not None:
            x = call.act_shard(x)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        y, caches, aux = T.forward(params["blocks"], cfg, x, positions,
                                   _attncall(S), dtype,
                                   want_cache=want_cache, remat=remat)
        return y, caches, aux, labels

    def _head(params, y):
        y = rmsnorm(params["final_norm"], y, cfg.norm_eps)
        return unembed(params["embed"], y, cfg, dtype)

    def _forward_y(params, batch):
        y, _, aux, labels = _forward(params, batch, False, call.remat,
                                     constrain=True)
        return y, labels, aux

    def loss(params, batch, ce_norm=None):
        """Mean CE over the labeled positions (+ the MoE aux loss);
        ``ce_norm`` replaces the CE's count of labeled positions (a mesh
        rank's share of a microbatch split over batch axes)."""
        y, labels, aux = _forward_y(params, batch)
        with trace.span("model.loss_head") as sp:
            (y,) = sp.inputs(y)
            ce = sp.output(cross_entropy(_head(params, y), labels,
                                         cfg.vocab_size, ce_norm))
        return ce + aux

    def logits(params, batch):
        return _head(params, _forward_y(params, batch)[0]).float()

    def _last_logits(params, y):
        return _head(params, y[:, -1:, :])[:, 0, :]

    def prefill(params, batch):
        y, caches, _, _ = _forward(params, batch, True, False)
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
        y, caches, _, _ = _forward(params, batch, True, False)
        B, S = y.shape[:2]
        cache = T.prefill_to_decode_cache(
            cfg, caches, S, init_cache(B, cache_len, y.device))
        return _last_logits(params, y), cache

    def _decode_hidden(params, cache, token, pos):
        x = embed(params["embed"], token[:, None], dtype)
        call_d = AttnCall(window=call.decode_window or 0,
                          softcap=call.softcap,
                          force_window=call.decode_window,
                          use_decode_kernel=call.use_decode_kernel,
                          exact_moe=call.exact_moe, moe_shard=call.moe_shard)
        y, cache = T.decode(params["blocks"], cfg, x, pos, cache, call_d,
                            dtype, mla_absorbed=call.mla_absorbed)
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
# input specs
# --------------------------------------------------------------------------- #

# one fold constant per batch field; the reference folds hash(name), which
# Python salts per process
_FIELD_FOLD = {"tokens": 1, "labels": 2, "embeds": 3, "patches": 4}


def batch_struct(cfg: ModelConfig, batch: int, seq: int):
    """(shape, dtype) of each field of a training/prefill batch of ``seq``
    residual positions: the vlm family's P = ``frontend_tokens`` patches
    take P of them, its text the other seq - P."""
    i32, f32 = torch.int32, torch.float32
    if cfg.family == "audio":
        return {"embeds": ((batch, seq, cfg.d_model), f32),
                "labels": ((batch, seq), i32)}
    if cfg.family == "vlm":
        P = cfg.frontend_tokens
        return {"patches": ((batch, P, cfg.d_model), f32),
                "tokens": ((batch, seq - P), i32),
                "labels": ((batch, seq - P), i32)}
    return {"tokens": ((batch, seq), i32), "labels": ((batch, seq), i32)}


def sample_batch(cfg: ModelConfig, stream, batch: int, seq: int, device):
    """A random batch matching ``batch_struct``, each field drawn from
    ``stream.fold(<its constant>)``: ids uniform in [0, vocab_size),
    embeddings standard normal (as the reference's)."""
    out = {}
    for name, (shape, dtype) in batch_struct(cfg, batch, seq).items():
        s = stream.fold(_FIELD_FOLD[name])
        if dtype == torch.float32:
            out[name] = s.normal(shape, device)
            continue
        ids = (s.uniform(shape, device) * cfg.vocab_size).floor_()
        out[name] = ids.to(torch.int32).clamp_(max=cfg.vocab_size - 1)
    return out
