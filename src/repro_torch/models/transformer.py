"""Decoder stack, dense and ssm families (counterpart of
``repro/models/transformer.py``): the full-sequence forward (training and
prefill), the decode cache and the one-token decode step.

Block parameters are stacked with a leading L dim, as in the reference tree
(``{"stack": {...}}``). Where the reference scans over layers under
``jax.checkpoint``, this loops over them in Python and wraps each layer in
``torch.utils.checkpoint`` (``remat``), so only layer inputs are kept for the
backward pass.

The dense family's decode cache is ``{"k", "v"}``, each (L, B, C, Hk, hd)
bf16; the ssm family's is ``{"mamba": {"h", "conv_x", "conv_B", "conv_C"}}``,
fp32, leaves stacked over L. Both are slot-major with the batch at dim 1;
``decode`` updates them in place.
"""
from __future__ import annotations

import torch
# torch.utils.checkpoint runs under torch._disable_dynamo, whose first call
# imports torch._dynamo. That import runs torch.fx's ``wrap``, which keeps
# ``inspect.currentframe()`` and so ties the whole calling stack (the first
# round's forward, with its activations and flat buffers) into a reference
# cycle that lives until the next cyclic GC. Importing it here, when the
# package is imported, leaves no round's frame on that stack.
import torch._dynamo  # noqa: F401
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (HUGE_WINDOW, AttnCall, init_rmsnorm,
                                       mlp, rmsnorm)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _init_block(gen, cfg: ModelConfig):
    d = cfg.d_model
    if cfg.family == "ssm":        # mamba block: a single pre-norm
        return {"norm1": init_rmsnorm(d, gen.device),
                "mamba": SSM.init_mamba2(gen, cfg)}
    return {"norm1": init_rmsnorm(d, gen.device),
            "norm2": init_rmsnorm(d, gen.device),
            "attn": Lyr.init_attention(gen, cfg),
            "ffn": Lyr.init_mlp(gen, d, cfg.d_ff)}


def init_stack(gen, cfg: ModelConfig):
    """All stack params: per-block leaves stacked with a leading L dim."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet")
    blocks = [_init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return {"stack": tree_map(lambda *xs: torch.stack(xs), *blocks)}


def layer_windows(cfg: ModelConfig, n_layers: int, force_window: int = 0):
    """Per-layer attention window, a list of ints; ``HUGE_WINDOW`` means
    global. The port's configs carry no local:global pattern (gemma3's is
    not ported), so every layer gets the same window."""
    if force_window:
        return [int(force_window)] * n_layers
    return [cfg.sliding_window or HUGE_WINDOW] * n_layers


def _layers(stack, n_layers):
    """The L per-layer parameter trees of a stacked tree. One unbind per
    leaf: its backward stacks the L layer grads in one buffer (indexing per
    layer would allocate a full (L, ...) zero tensor for every layer's
    grad)."""
    per_leaf = [leaf.unbind(0) for leaf in tree_leaves(stack)]
    return [tree_unflatten(stack, [layers[i] for layers in per_leaf])
            for i in range(n_layers)]


def _block_fwd(bp, cfg, x, positions, window, call: AttnCall, dtype,
               want_cache=True):
    """One block. Returns (x, cache): the attention's (k, v), or the mamba
    block's decode cache (``want_cache``; else None)."""
    h_in = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if cfg.family == "ssm":
        out = SSM.mamba2_forward(bp["mamba"], cfg, h_in, dtype,
                                 return_cache=want_cache,
                                 use_ssd_kernel=call.use_ssd_kernel)
        h, mc = out if want_cache else (out, None)
        return x + h, mc
    c = AttnCall(window=window, softcap=call.softcap, chunk=call.chunk,
                 use_flash_kernel=call.use_flash_kernel)
    h, kv = Lyr.attention(bp["attn"], cfg, h_in, positions, c, dtype)
    x = x + h
    f_in = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + mlp(bp["ffn"], f_in, cfg.act, dtype), kv


def _block_remat(bp, cfg, x, positions, window, call, dtype):
    return _block_fwd(bp, cfg, x, positions, window, call, dtype,
                      want_cache=False)[0]


def forward(params, cfg: ModelConfig, x, positions, call: AttnCall, dtype,
            want_cache=False, remat=True):
    """x (B,S,d) residual stream -> (y (B,S,d), caches). With
    ``want_cache``, ``caches["stack"]`` holds the per-layer caches stacked
    over L: ``(k, v)``, each (L,B,S,Hk,hd), for the dense family, the
    ``mamba2_init_cache`` tree for the ssm family; else ``caches`` is
    empty."""
    wins = layer_windows(cfg, cfg.n_layers, call.force_window)
    per_layer = []
    for bp, win in zip(_layers(params["stack"], cfg.n_layers), wins):
        if remat and torch.is_grad_enabled() and not want_cache:
            x = checkpoint(_block_remat, bp, cfg, x, positions, win, call,
                           dtype, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x, c = _block_fwd(bp, cfg, x, positions, win, call, dtype,
                              want_cache)
            if want_cache:
                per_layer.append(c)
    caches = {"stack": tree_map(lambda *xs: torch.stack(xs), *per_layer)} \
        if want_cache else {}
    return x, caches


# --------------------------------------------------------------------------- #
# decode (one token, cache carried)
# --------------------------------------------------------------------------- #


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                      dtype=torch.bfloat16):
    """An empty decode cache: k and v (L, batch, cache_len, Hk, hd) in
    ``dtype`` for the dense family; for the ssm family the fp32
    ``mamba2_init_cache`` leaves stacked over L (``cache_len`` unused: the
    state does not grow with the context)."""
    if cfg.family == "ssm":
        one = SSM.mamba2_init_cache(cfg, batch, device)
        return {"mamba": tree_map(
            lambda t: t.new_zeros((cfg.n_layers,) + tuple(t.shape)), one)}
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ring_place(src, C, S, axis):
    """Place a length-S sequence axis into a C-slot ring at slot = pos % C.

    Keeps the last min(S, C) positions (the only ones a windowed decode can
    ever attend to) so decode at pos = S reconstructs k_pos exactly like a
    cache that was filled token by token."""
    if S <= C:
        shape = list(src.shape)
        shape[axis] = C
        out = torch.zeros(shape, dtype=src.dtype, device=src.device)
        out.narrow(axis, 0, S).copy_(src)
        return out
    # slot c holds the unique position p in [S-C, S) with p % C == c
    c = torch.arange(C, device=src.device)
    p = (S - C) + torch.remainder(c - (S - C), C)
    return src.index_select(axis, p)


def prefill_to_decode_cache(cfg: ModelConfig, caches, prompt_len: int,
                            cache):
    """Convert ``forward(want_cache=True)`` caches into the decode layout.

    ``cache`` is a fresh ``init_decode_cache`` tree whose leaves fix the
    target shapes and dtype (including the ring size C when
    ``decode_window`` is on); the populated copy is returned, ready for
    decode at pos = prompt_len."""
    if cfg.family == "ssm":
        new = dict(cache)
        new["mamba"] = tree_map(lambda t, s: s.to(t.dtype), cache["mamba"],
                                caches["stack"])
        return new
    C = cache["k"].shape[2]
    k, v = caches["stack"]                           # (L,B,S,Hk,hd)
    new = dict(cache)
    new["k"] = _ring_place(k, C, prompt_len, axis=2).to(cache["k"].dtype)
    new["v"] = _ring_place(v, C, prompt_len, axis=2).to(cache["v"].dtype)
    return new


def decode(params, cfg: ModelConfig, x, pos, cache, call: AttnCall, dtype):
    """x (B,1,d), pos an int or a (B,) per-slot tensor -> (y (B,1,d),
    cache). The new token's K/V (dense) or the recurrent state and conv
    tails (ssm, where ``pos`` is not used) are written into ``cache`` in
    place, layer by layer; the same dict is returned."""
    if cfg.family == "ssm":
        mc = cache["mamba"]
        for i, bp in enumerate(_layers(params["stack"], cfg.n_layers)):
            h_in = rmsnorm(bp["norm1"], x, cfg.norm_eps)
            h, _ = SSM.mamba2_decode(bp["mamba"], cfg, h_in,
                                     {k: v[i] for k, v in mc.items()}, dtype)
            x = x + h
        return x, cache
    wins = layer_windows(cfg, cfg.n_layers, call.force_window)
    for i, (bp, win) in enumerate(zip(_layers(params["stack"],
                                              cfg.n_layers), wins)):
        h_in = rmsnorm(bp["norm1"], x, cfg.norm_eps)
        c = AttnCall(window=win, softcap=call.softcap,
                     use_decode_kernel=call.use_decode_kernel)
        h, _, _ = Lyr.attention_decode(bp["attn"], cfg, h_in, pos,
                                       cache["k"][i], cache["v"][i], c,
                                       dtype)
        x = x + h
        f_in = rmsnorm(bp["norm2"], x, cfg.norm_eps)
        x = x + mlp(bp["ffn"], f_in, cfg.act, dtype)
    return x, cache
