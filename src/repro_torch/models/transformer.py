"""Decoder stack, dense, ssm and hybrid families (counterpart of
``repro/models/transformer.py``): the full-sequence forward (training and
prefill), the decode cache and the one-token decode step.

Block parameters are stacked with a leading L dim, as in the reference tree
(``{"stack": {...}}``). Where the reference scans over layers under
``jax.checkpoint``, this loops over them in Python and wraps each layer in
``torch.utils.checkpoint`` (``remat``), so only layer inputs are kept for the
backward pass.

The hybrid family (zamba2) is the ssm stack plus one weight-tied attention
+ MLP block, ``{"shared": {...}}``, run on the residual stream after every
``hybrid_attn_every``-th mamba layer (layer i with i % every == every - 1,
its application i // every); its gradient sums over the applications.

The dense family's decode cache is ``{"k", "v"}``, each (L, B, C, Hk, hd)
bf16; the ssm family's is ``{"mamba": {"h", "conv_x", "conv_B", "conv_C"}}``,
fp32, leaves stacked over L; the hybrid's is the ssm cache plus
``"shared_k"`` and ``"shared_v"``, each (L // every, B, C, Hk, hd) bf16, one
row per application. All are slot-major with the batch at dim 1; ``decode``
updates them in place.
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


def _is_ssm(cfg: ModelConfig) -> bool:
    """Mamba blocks in the stack: the ssm and hybrid families."""
    return cfg.family in ("ssm", "hybrid")


def _init_block(gen, cfg: ModelConfig):
    d = cfg.d_model
    if _is_ssm(cfg):               # mamba block: a single pre-norm
        return {"norm1": init_rmsnorm(d, gen.device),
                "mamba": SSM.init_mamba2(gen, cfg)}
    return {"norm1": init_rmsnorm(d, gen.device),
            "norm2": init_rmsnorm(d, gen.device),
            "attn": Lyr.init_attention(gen, cfg),
            "ffn": Lyr.init_mlp(gen, d, cfg.d_ff)}


def _init_shared_block(gen, cfg: ModelConfig):
    """zamba2: the single weight-tied attention + MLP block."""
    d = cfg.d_model
    return {"norm1": init_rmsnorm(d, gen.device),
            "attn": Lyr.init_attention(gen, cfg),
            "norm2": init_rmsnorm(d, gen.device),
            "ffn": Lyr.init_mlp(gen, d, cfg.d_ff)}


def init_stack(gen, cfg: ModelConfig):
    """All stack params: per-block leaves stacked with a leading L dim, and
    the hybrid's shared block (``"shared"``).

    The (L, ...) leaves are allocated once and block i is initialised into
    slice i, in layer order (the draw order of one block after another), so
    at most one block lives beside the stack."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet")
    stack = None
    for i in range(cfg.n_layers):
        block = _init_block(gen, cfg)
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((cfg.n_layers,)
                                                   + tuple(x.shape)), block)
        tree_map(lambda s, x: s[i].copy_(x), stack, block)
        del block
    p = {"stack": stack}
    if cfg.hybrid_attn_every:
        p["shared"] = _init_shared_block(gen, cfg)
    return p


def layer_windows(cfg: ModelConfig, n_layers: int, force_window: int = 0):
    """Per-layer attention window, a list of ints; ``HUGE_WINDOW`` means
    global. The reference's schedule: ``force_window`` everywhere; else
    global everywhere without a ``sliding_window``; else the window
    everywhere when ``local_global_ratio`` r is 0; else layer i is global
    iff i % (r + 1) == r (gemma3's 5:1: layers 5, 11, 17, 23, 29 of
    34)."""
    if force_window:
        return [int(force_window)] * n_layers
    if not cfg.sliding_window:
        return [HUGE_WINDOW] * n_layers
    r = cfg.local_global_ratio
    if not r:
        return [cfg.sliding_window] * n_layers
    return [HUGE_WINDOW if i % (r + 1) == r else cfg.sliding_window
            for i in range(n_layers)]


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
    if _is_ssm(cfg):
        h_in = rmsnorm(bp["norm1"], x, cfg.norm_eps)
        out = SSM.mamba2_forward(bp["mamba"], cfg, h_in, dtype,
                                 return_cache=want_cache,
                                 use_ssd_kernel=call.use_ssd_kernel)
        h, mc = out if want_cache else (out, None)
        return x + h, mc
    return _attn_block(bp, cfg, x, positions, window, call, dtype)


def _attn_block(p, cfg, x, positions, window, call: AttnCall, dtype):
    """An attention + MLP block (the dense family's, and the hybrid's shared
    one) on the residual stream: norm1, attention (K4 under
    ``use_flash_kernel``), residual add, norm2, MLP, residual add. Returns
    (x, (k, v))."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    c = AttnCall(window=window, softcap=call.softcap, chunk=call.chunk,
                 use_flash_kernel=call.use_flash_kernel)
    h, kv = Lyr.attention(p["attn"], cfg, h, positions, c, dtype)
    x = x + h
    f_in = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], f_in, cfg.act, dtype), kv


def _applies_shared(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid's shared block runs after stack layer ``i``."""
    every = cfg.hybrid_attn_every
    return bool(every) and i % every == every - 1


def _layer_fwd(bp, sp, cfg, x, positions, window, call, dtype, i,
               want_cache=True):
    """Stack layer ``i``, then the shared block where it applies. Returns
    (x, the block's cache, the shared block's (k, v) or None)."""
    x, c = _block_fwd(bp, cfg, x, positions, window, call, dtype,
                      want_cache)
    skv = None
    if _applies_shared(cfg, i):
        x, skv = _attn_block(sp, cfg, x, positions, window, call, dtype)
    return x, c, skv


def _layer_remat(bp, sp, cfg, x, positions, window, call, dtype, i):
    return _layer_fwd(bp, sp, cfg, x, positions, window, call, dtype, i,
                      want_cache=False)[0]


def forward(params, cfg: ModelConfig, x, positions, call: AttnCall, dtype,
            want_cache=False, remat=True):
    """x (B,S,d) residual stream -> (y (B,S,d), caches). With
    ``want_cache``, ``caches["stack"]`` holds the per-layer caches stacked
    over L: ``(k, v)``, each (L,B,S,Hk,hd), for the dense family, the
    ``mamba2_init_cache`` tree for the ssm family, and for the hybrid
    ``{"mamba": that tree, "skv": (k, v)}`` with the shared block's K/V of
    its L // every applications only, each (L // every,B,S,Hk,hd) (the
    reference's scan emits zeros for the other layers); else ``caches`` is
    empty. Under ``remat`` the checkpointed unit is the whole layer, the
    shared block included."""
    wins = layer_windows(cfg, cfg.n_layers, call.force_window)
    sp = params.get("shared")
    per_layer, shared_kv = [], []
    for i, (bp, win) in enumerate(zip(_layers(params["stack"],
                                              cfg.n_layers), wins)):
        if remat and torch.is_grad_enabled() and not want_cache:
            x = checkpoint(_layer_remat, bp, sp, cfg, x, positions, win,
                           call, dtype, i, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x, c, skv = _layer_fwd(bp, sp, cfg, x, positions, win, call,
                                   dtype, i, want_cache)
            if want_cache:
                per_layer.append(c)
                if skv is not None:
                    shared_kv.append(skv)
    if not want_cache:
        return x, {}
    stack = tree_map(lambda *xs: torch.stack(xs), *per_layer)
    if cfg.hybrid_attn_every:
        stack = {"mamba": stack,
                 "skv": tree_map(lambda *xs: torch.stack(xs), *shared_kv)}
    return x, {"stack": stack}


# --------------------------------------------------------------------------- #
# decode (one token, cache carried)
# --------------------------------------------------------------------------- #


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                      dtype=torch.bfloat16):
    """An empty decode cache: k and v (L, batch, cache_len, Hk, hd) in
    ``dtype`` for the dense family; for the ssm family the fp32
    ``mamba2_init_cache`` leaves stacked over L (``cache_len`` unused: the
    state does not grow with the context); for the hybrid that tree and
    ``shared_k`` / ``shared_v``, each (L // every, batch, cache_len, Hk,
    hd) in ``dtype``."""
    if _is_ssm(cfg):
        one = SSM.mamba2_init_cache(cfg, batch, device)
        c = {"mamba": tree_map(
            lambda t: t.new_zeros((cfg.n_layers,) + tuple(t.shape)), one)}
        if cfg.hybrid_attn_every:
            shape = (cfg.n_layers // cfg.hybrid_attn_every, batch,
                     cache_len, cfg.n_kv_heads, cfg.head_dim)
            c["shared_k"] = torch.zeros(shape, dtype=dtype, device=device)
            c["shared_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return c
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
    if _is_ssm(cfg):
        st = caches["stack"]
        mc = st["mamba"] if cfg.hybrid_attn_every else st
        new = dict(cache)
        new["mamba"] = tree_map(lambda t, s: s.to(t.dtype), cache["mamba"],
                                mc)
        if cfg.hybrid_attn_every:
            C = cache["shared_k"].shape[2]
            for key, src in zip(("shared_k", "shared_v"), st["skv"]):
                new[key] = _ring_place(src, C, prompt_len, axis=2).to(
                    cache[key].dtype)
        return new
    C = cache["k"].shape[2]
    k, v = caches["stack"]                           # (L,B,S,Hk,hd)
    new = dict(cache)
    new["k"] = _ring_place(k, C, prompt_len, axis=2).to(cache["k"].dtype)
    new["v"] = _ring_place(v, C, prompt_len, axis=2).to(cache["v"].dtype)
    return new


def _attn_block_decode(p, cfg, x, pos, kc, vc, window, call: AttnCall,
                       dtype):
    """One token through an attention + MLP block (``_attn_block``'s
    decode): its K/V written into ``kc`` / ``vc`` in place; K5 under
    ``use_decode_kernel``."""
    h_in = rmsnorm(p["norm1"], x, cfg.norm_eps)
    c = AttnCall(window=window, softcap=call.softcap,
                 use_decode_kernel=call.use_decode_kernel)
    h, _, _ = Lyr.attention_decode(p["attn"], cfg, h_in, pos, kc, vc, c,
                                   dtype)
    x = x + h
    f_in = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], f_in, cfg.act, dtype)


def decode(params, cfg: ModelConfig, x, pos, cache, call: AttnCall, dtype):
    """x (B,1,d), pos an int or a (B,) per-slot tensor -> (y (B,1,d),
    cache). The new token's K/V (dense; the hybrid's shared block, in its
    application's row) and the recurrent state and conv tails (ssm and
    hybrid; the mamba step does not read ``pos``) are written into
    ``cache`` in place, layer by layer; the same dict is returned."""
    wins = layer_windows(cfg, cfg.n_layers, call.force_window)
    layers = zip(_layers(params["stack"], cfg.n_layers), wins)
    if not _is_ssm(cfg):
        for i, (bp, win) in enumerate(layers):
            x = _attn_block_decode(bp, cfg, x, pos, cache["k"][i],
                                   cache["v"][i], win, call, dtype)
        return x, cache
    mc, sp = cache["mamba"], params.get("shared")
    for i, (bp, win) in enumerate(layers):
        h_in = rmsnorm(bp["norm1"], x, cfg.norm_eps)
        h, _ = SSM.mamba2_decode(bp["mamba"], cfg, h_in,
                                 {k: v[i] for k, v in mc.items()}, dtype)
        x = x + h
        if _applies_shared(cfg, i):
            app = i // cfg.hybrid_attn_every
            x = _attn_block_decode(sp, cfg, x, pos, cache["shared_k"][app],
                                   cache["shared_v"][app], win, call, dtype)
    return x, cache
