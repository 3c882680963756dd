"""Decoder stack, dense, moe, ssm and hybrid families (counterpart of
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

The moe family's block is the dense one with a routed MoE FFN
(``models/moe.py``; its router's load-balance loss is summed over the
layers as ``forward``'s aux). Its first ``moe.moe_layer_start`` layers are
dense blocks of FFN width ``moe.d_ff_dense`` (or ``d_ff``), kept unstacked
in ``params["prefix"]``, a list, and run at full attention; their decode
cache is ``"pk"`` / ``"pv"``, each (n_prefix, B, C, Hk, hd) bf16, beside
the stack's ``"k"`` / ``"v"``.
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
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (HUGE_WINDOW, AttnCall, init_rmsnorm,
                                       mlp, rmsnorm)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _is_ssm(cfg: ModelConfig) -> bool:
    """Mamba blocks in the stack: the ssm and hybrid families."""
    return cfg.family in ("ssm", "hybrid")


def _n_prefix(cfg: ModelConfig) -> int:
    """A MoE model's dense prefix layers (0 for the other families)."""
    return cfg.moe.moe_layer_start if cfg.moe else 0


def _init_block(gen, cfg: ModelConfig):
    d = cfg.d_model
    if _is_ssm(cfg):               # mamba block: a single pre-norm
        return {"norm1": init_rmsnorm(d, gen.device),
                "mamba": SSM.init_mamba2(gen, cfg)}
    ffn = MOE.init_moe(gen, cfg) if cfg.family == "moe" \
        else Lyr.init_mlp(gen, d, cfg.d_ff)
    return {"norm1": init_rmsnorm(d, gen.device),
            "norm2": init_rmsnorm(d, gen.device),
            "attn": Lyr.init_attention(gen, cfg), "ffn": ffn}


def _init_dense_block(gen, cfg: ModelConfig, d_ff):
    """A dense-FFN block: a MoE model's dense prefix layer."""
    d = cfg.d_model
    return {"norm1": init_rmsnorm(d, gen.device),
            "norm2": init_rmsnorm(d, gen.device),
            "attn": Lyr.init_attention(gen, cfg),
            "ffn": Lyr.init_mlp(gen, d, d_ff)}


def _init_shared_block(gen, cfg: ModelConfig):
    """zamba2: the single weight-tied attention + MLP block."""
    d = cfg.d_model
    return {"norm1": init_rmsnorm(d, gen.device),
            "attn": Lyr.init_attention(gen, cfg),
            "norm2": init_rmsnorm(d, gen.device),
            "ffn": Lyr.init_mlp(gen, d, cfg.d_ff)}


def init_stack(gen, cfg: ModelConfig):
    """All stack params: per-block leaves stacked with a leading L dim, a MoE
    model's dense prefix blocks (``"prefix"``, a list) and the hybrid's
    shared block (``"shared"``).

    The (L, ...) leaves are allocated once and block i is initialised into
    slice i, in layer order (the draw order of one block after another), so
    at most one block lives beside the stack."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet")
    n_prefix = _n_prefix(cfg)
    Ls = cfg.n_layers - n_prefix
    stack = None
    for i in range(Ls):
        block = _init_block(gen, cfg)
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((Ls,) + tuple(x.shape)),
                             block)
        tree_map(lambda s, x: s[i].copy_(x), stack, block)
        del block
    p = {"stack": stack}
    if n_prefix:
        d_ff = cfg.moe.d_ff_dense or cfg.d_ff
        p["prefix"] = [_init_dense_block(gen, cfg, d_ff)
                       for _ in range(n_prefix)]
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
    """One block. Returns (x, cache, aux): the attention's (k, v), or the
    mamba block's decode cache (``want_cache``; else None), and the MoE
    router's load-balance loss (0.0 without a MoE FFN)."""
    if _is_ssm(cfg):
        h_in = rmsnorm(bp["norm1"], x, cfg.norm_eps)
        out = SSM.mamba2_forward(bp["mamba"], cfg, h_in, dtype,
                                 return_cache=want_cache,
                                 use_ssd_kernel=call.use_ssd_kernel)
        h, mc = out if want_cache else (out, None)
        return x + h, mc, 0.0
    return _attn_block(bp, cfg, x, positions, window, call, dtype)


def _ffn(p, cfg, x, call: AttnCall, dtype):
    """The block's FFN: the routed MoE where ``p`` has a router (capacity
    drops unless ``call.exact_moe``), else the gated MLP. Returns (out,
    aux)."""
    if "router" in p:
        return MOE.moe_apply(p, cfg, x, cfg.act, dtype,
                             no_drop=call.exact_moe)
    return mlp(p, x, cfg.act, dtype), 0.0


def _attn_block(p, cfg, x, positions, window, call: AttnCall, dtype):
    """An attention + FFN block (the dense and moe families', a MoE model's
    dense prefix, and the hybrid's shared one) on the residual stream:
    norm1, attention (K4 under ``use_flash_kernel``), residual add, norm2,
    FFN (MLP or MoE), residual add. Returns (x, (k, v), aux)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    c = AttnCall(window=window, softcap=call.softcap, chunk=call.chunk,
                 use_flash_kernel=call.use_flash_kernel)
    h, kv = Lyr.attention(p["attn"], cfg, h, positions, c, dtype)
    x = x + h
    f, aux = _ffn(p["ffn"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps), call,
                  dtype)
    return x + f, kv, aux


def _applies_shared(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid's shared block runs after stack layer ``i``."""
    every = cfg.hybrid_attn_every
    return bool(every) and i % every == every - 1


def _layer_fwd(bp, sp, cfg, x, positions, window, call, dtype, i,
               want_cache=True):
    """Stack layer ``i``, then the shared block where it applies. Returns
    (x, the block's cache, the shared block's (k, v) or None, aux)."""
    x, c, aux = _block_fwd(bp, cfg, x, positions, window, call, dtype,
                           want_cache)
    skv = None
    if _applies_shared(cfg, i):
        x, skv, _ = _attn_block(sp, cfg, x, positions, window, call, dtype)
    return x, c, skv, aux


def _layer_remat(bp, sp, cfg, x, positions, window, call, dtype, i):
    x, _, _, aux = _layer_fwd(bp, sp, cfg, x, positions, window, call, dtype,
                              i, want_cache=False)
    return x, aux


def forward(params, cfg: ModelConfig, x, positions, call: AttnCall, dtype,
            want_cache=False, remat=True):
    """x (B,S,d) residual stream -> (y (B,S,d), caches, aux). With
    ``want_cache``, ``caches["stack"]`` holds the per-layer caches stacked
    over the stack's L layers: ``(k, v)``, each (L,B,S,Hk,hd), for the
    dense and moe families, the ``mamba2_init_cache`` tree for the ssm
    family, and for the hybrid ``{"mamba": that tree, "skv": (k, v)}`` with
    the shared block's K/V of its L // every applications only, each
    (L // every,B,S,Hk,hd) (the reference's scan emits zeros for the other
    layers); a MoE model's dense prefix block i adds ``caches["prefix{i}"]``,
    its (k, v); else ``caches`` is empty. ``aux`` is the MoE router loss
    summed over the layers (0.0 for the other families). The prefix blocks
    run first, at full attention (``force_window`` does not reach them, as
    in the reference). Under ``remat`` the checkpointed unit is the whole
    stack layer, the shared block included; its aux comes out of the
    checkpoint beside x."""
    caches, aux_total = {}, 0.0
    for i, bp in enumerate(params.get("prefix", [])):
        x, kv, aux = _attn_block(bp, cfg, x, positions, HUGE_WINDOW, call,
                                 dtype)
        aux_total = aux_total + aux
        if want_cache:
            caches[f"prefix{i}"] = kv
    Ls = cfg.n_layers - _n_prefix(cfg)
    wins = layer_windows(cfg, Ls, call.force_window)
    sp = params.get("shared")
    per_layer, shared_kv = [], []
    for i, (bp, win) in enumerate(zip(_layers(params["stack"], Ls), wins)):
        if remat and torch.is_grad_enabled() and not want_cache:
            x, aux = checkpoint(_layer_remat, bp, sp, cfg, x, positions, win,
                                call, dtype, i, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, c, skv, aux = _layer_fwd(bp, sp, cfg, x, positions, win, call,
                                        dtype, i, want_cache)
            if want_cache:
                per_layer.append(c)
                if skv is not None:
                    shared_kv.append(skv)
        aux_total = aux_total + aux
    if not want_cache:
        return x, caches, aux_total
    stack = tree_map(lambda *xs: torch.stack(xs), *per_layer)
    if cfg.hybrid_attn_every:
        stack = {"mamba": stack,
                 "skv": tree_map(lambda *xs: torch.stack(xs), *shared_kv)}
    caches["stack"] = stack
    return x, caches, aux_total


# --------------------------------------------------------------------------- #
# decode (one token, cache carried)
# --------------------------------------------------------------------------- #


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                      dtype=torch.bfloat16):
    """An empty decode cache: k and v (L, batch, cache_len, Hk, hd) in
    ``dtype`` for the dense and moe families over the stack's L layers,
    and ``pk`` / ``pv`` (n_prefix, ...) for a MoE model's dense prefix; for
    the ssm family the fp32 ``mamba2_init_cache`` leaves stacked over L
    (``cache_len`` unused: the state does not grow with the context); for
    the hybrid that tree and ``shared_k`` / ``shared_v``, each (L // every,
    batch, cache_len, Hk, hd) in ``dtype``."""
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
    n_prefix = _n_prefix(cfg)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros((cfg.n_layers - n_prefix,) + shape, dtype=dtype,
                          device=device),
         "v": torch.zeros((cfg.n_layers - n_prefix,) + shape, dtype=dtype,
                          device=device)}
    if n_prefix:
        c["pk"] = torch.zeros((n_prefix,) + shape, dtype=dtype,
                              device=device)
        c["pv"] = torch.zeros((n_prefix,) + shape, dtype=dtype,
                              device=device)
    return c


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
    if "pk" in cache:
        n_prefix = cache["pk"].shape[0]
        for key, j in (("pk", 0), ("pv", 1)):
            src = torch.stack([caches[f"prefix{i}"][j]
                               for i in range(n_prefix)])
            new[key] = _ring_place(src, C, prompt_len, axis=2).to(
                cache[key].dtype)
    return new


def _attn_block_decode(p, cfg, x, pos, kc, vc, window, call: AttnCall,
                       dtype):
    """One token through an attention + FFN block (``_attn_block``'s
    decode): its K/V written into ``kc`` / ``vc`` in place; K5 under
    ``use_decode_kernel``. A MoE FFN routes each row's one token on its
    own (capacity 8, or K under ``exact_moe``: never a drop); its aux is
    dropped, as the reference's decode drops it."""
    h_in = rmsnorm(p["norm1"], x, cfg.norm_eps)
    c = AttnCall(window=window, softcap=call.softcap,
                 use_decode_kernel=call.use_decode_kernel)
    h, _, _ = Lyr.attention_decode(p["attn"], cfg, h_in, pos, kc, vc, c,
                                   dtype)
    x = x + h
    f, _ = _ffn(p["ffn"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps), call,
                dtype)
    return x + f


def decode(params, cfg: ModelConfig, x, pos, cache, call: AttnCall, dtype):
    """x (B,1,d), pos an int or a (B,) per-slot tensor -> (y (B,1,d),
    cache). The new token's K/V (dense; the hybrid's shared block, in its
    application's row) and the recurrent state and conv tails (ssm and
    hybrid; the mamba step does not read ``pos``) are written into
    ``cache`` in place, layer by layer; the same dict is returned. A MoE
    model's dense prefix blocks run first on ``pk`` / ``pv`` at
    ``call.window`` (the reference's)."""
    for i, bp in enumerate(params.get("prefix", [])):
        x = _attn_block_decode(bp, cfg, x, pos, cache["pk"][i],
                               cache["pv"][i], call.window, call, dtype)
    Ls = cfg.n_layers - _n_prefix(cfg)
    wins = layer_windows(cfg, Ls, call.force_window)
    layers = zip(_layers(params["stack"], Ls), wins)
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
