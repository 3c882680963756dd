"""Decoder stack, dense, moe, ssm, hybrid, audio and vlm families
(counterpart of ``repro/models/transformer.py``): the full-sequence forward
(training and prefill), the decode cache and the one-token decode step.

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

A model with ``cfg.mla`` (deepseek-v2) runs multi-head latent attention
(``models/mla.py``) in every block, its dense prefix blocks included; its
decode cache is the latent one: ``"ckv"`` (L, B, C, kv_lora) and
``"kpe"`` (L, B, C, rope), bf16, and ``"p_ckv"`` / ``"p_kpe"`` (n_prefix,
...) for the prefix. It is not a ring: ``prefill_to_decode_cache`` asserts
that the prompt fits.

The audio (musicgen) and vlm (internvl2) families are dense stacks; their
frontends are stubs that feed the residual stream (``models/model.py``).

The nemotron_h family is a pattern stack: layer i is ``x + mixer(RMSNorm
(x))`` with the mixer of the i-th letter of ``cfg.layer_pattern`` (M a
mamba2 layer, E the expert share of ``models/moe.share_apply``, * attention
without positions), each kind's leaves stacked apart: ``{"mamba":
{"norm1", "mamba"}, "moe": {"norm1", "moe"}, "attention": {"norm1",
"attn"}}``, each with a leading dim of that kind's layer count. Under
remat each layer is the checkpointed unit, and an expert layer gets a memo
that its recompute routes from. It trains; it has no decode cache.
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
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (HUGE_WINDOW, AttnCall, init_rmsnorm,
                                       mlp, rmsnorm)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


# the pattern stack's letters and the names of their stacks
PATTERN_KINDS = {"M": "mamba", "E": "moe", "*": "attention"}


def _is_ssm(cfg: ModelConfig) -> bool:
    """Mamba blocks in the stack: the ssm and hybrid families."""
    return cfg.family in ("ssm", "hybrid")


def _n_prefix(cfg: ModelConfig) -> int:
    """A MoE model's dense prefix layers (0 for the other families)."""
    return cfg.moe.moe_layer_start if cfg.moe else 0


def _cache_keys(cfg: ModelConfig):
    """The decode cache's keys: the stack's pair and the dense prefix's."""
    if cfg.mla:
        return ("ckv", "kpe"), ("p_ckv", "p_kpe")
    return ("k", "v"), ("pk", "pv")


def _init_attention(gen, cfg: ModelConfig):
    """The block's attention: MLA where the config has one."""
    return MLA.init_mla(gen, cfg) if cfg.mla else Lyr.init_attention(gen,
                                                                     cfg)


def _init_block(gen, cfg: ModelConfig):
    d = cfg.d_model
    if _is_ssm(cfg):               # mamba block: a single pre-norm
        return {"norm1": init_rmsnorm(d, gen.device),
                "mamba": SSM.init_mamba2(gen, cfg)}
    ffn = MOE.init_moe(gen, cfg) if cfg.family == "moe" \
        else Lyr.init_mlp(gen, d, cfg.d_ff)
    return {"norm1": init_rmsnorm(d, gen.device),
            "norm2": init_rmsnorm(d, gen.device),
            "attn": _init_attention(gen, cfg), "ffn": ffn}


def _init_dense_block(gen, cfg: ModelConfig, d_ff):
    """A dense-FFN block: a MoE model's dense prefix layer."""
    d = cfg.d_model
    return {"norm1": init_rmsnorm(d, gen.device),
            "norm2": init_rmsnorm(d, gen.device),
            "attn": _init_attention(gen, cfg),
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
    at most one block lives beside the stack. The audio and vlm families
    are dense stacks; a pattern stack (nemotron_h) has one stack a kind."""
    if cfg.layer_pattern:
        return _init_pattern(gen, cfg)
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


def _init_pattern_block(gen, cfg: ModelConfig, kind: str):
    d = cfg.d_model
    if kind == "M":
        mixer = {"mamba": SSM.init_mamba2(gen, cfg)}
    elif kind == "E":
        mixer = {"moe": MOE.init_share(gen, cfg)}
    else:
        mixer = {"attn": Lyr.init_attention(gen, cfg)}
    return {"norm1": init_rmsnorm(d, gen.device), **mixer}


def _init_pattern(gen, cfg: ModelConfig):
    """The pattern stack's leaves: one stack a kind, layer i drawn into its
    kind's next slot, in layer order."""
    kinds = cfg.layer_kinds
    stacks, filled = {}, {}
    for kind in kinds:
        name = PATTERN_KINDS[kind]
        block = _init_pattern_block(gen, cfg, kind)
        if name not in stacks:
            n = kinds.count(kind)
            stacks[name] = tree_map(
                lambda x: x.new_empty((n,) + tuple(x.shape)), block)
        i = filled.get(name, 0)
        tree_map(lambda s, x: s[i].copy_(x), stacks[name], block)
        filled[name] = i + 1
        del block
    return stacks


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
                                 return_cache=want_cache)
        h, mc = out if want_cache else (out, None)
        return x + h, mc, 0.0
    return _attn_block(bp, cfg, x, positions, window, call, dtype)


def _ffn(p, cfg, x, call: AttnCall, dtype):
    """The block's FFN: the routed MoE where ``p`` has a router (capacity
    drops unless ``call.exact_moe``), else the gated MLP. Returns (out,
    aux)."""
    if "router" in p:
        return MOE.moe_apply(p, cfg, x, cfg.act, dtype,
                             no_drop=call.exact_moe, shard=call.moe_shard)
    return mlp(p, x, cfg.act, dtype), 0.0


def _attn_block(p, cfg, x, positions, window, call: AttnCall, dtype):
    """An attention + FFN block (the dense, moe, audio and vlm families', a
    MoE model's dense prefix, and the hybrid's shared one) on the residual
    stream: norm1, attention (K4 under ``use_flash_kernel``; MLA where the
    config has it, which takes no window and no softcap, as the
    reference's), residual add, norm2, FFN (MLP or MoE), residual add.
    Returns (x, (k, v) or MLA's (c_kv, k_pe), aux)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.mla:
        h, kv = MLA.mla_attention(p["attn"], cfg, h, positions, dtype,
                                  chunk=call.chunk,
                                  use_flash_kernel=call.use_flash_kernel)
    else:
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


def _pattern_layer(kind, bp, cfg, x, positions, call: AttnCall, dtype,
                   memo=None):
    """One layer of a pattern stack: x + mixer(RMSNorm(x))."""
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if kind == "M":
        h = SSM.mamba2_forward(bp["mamba"], cfg, h, dtype)
    elif kind == "E":
        h = MOE.share_apply(bp["moe"], cfg, h, dtype, memo)
    else:
        c = AttnCall(softcap=call.softcap, chunk=call.chunk,
                     use_flash_kernel=call.use_flash_kernel)
        h, _ = Lyr.attention(bp["attn"], cfg, h, positions, c, dtype)
    return x + h


def _pattern_forward(params, cfg: ModelConfig, x, positions, call, dtype,
                     remat):
    kinds = cfg.layer_kinds
    stacks = {name: iter(_layers(params[name], kinds.count(kind)))
              for kind, name in PATTERN_KINDS.items() if kind in kinds}
    for kind in kinds:
        bp = next(stacks[PATTERN_KINDS[kind]])
        if remat and torch.is_grad_enabled():
            x = checkpoint(_pattern_layer, kind, bp, cfg, x, positions, call,
                           dtype, {}, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _pattern_layer(kind, bp, cfg, x, positions, call, dtype)
    return x


def forward(params, cfg: ModelConfig, x, positions, call: AttnCall, dtype,
            want_cache=False, remat=True):
    """x (B,S,d) residual stream -> (y (B,S,d), caches, aux). With
    ``want_cache``, ``caches["stack"]`` holds the per-layer caches stacked
    over the stack's L layers: ``(k, v)``, each (L,B,S,Hk,hd), for the
    dense, moe, audio and vlm families (MLA: ``(c_kv, k_pe)``, (L,B,S,
    kv_lora) and (L,B,S,rope)), the ``mamba2_init_cache`` tree for the ssm
    family, and for the hybrid ``{"mamba": that tree, "skv": (k, v)}`` with
    the shared block's K/V of its L // every applications only, each
    (L // every,B,S,Hk,hd) (the reference's scan emits zeros for the other
    layers); a MoE model's dense prefix block i adds ``caches["prefix{i}"]``,
    its (k, v) (or (c_kv, k_pe)); else ``caches`` is empty. ``aux`` is the
    MoE router loss summed over the layers (0.0 for the other families).
    The prefix blocks
    run first, at full attention (``force_window`` does not reach them, as
    in the reference). Under ``remat`` the checkpointed unit is the whole
    stack layer, the shared block included; its aux comes out of the
    checkpoint beside x. A pattern stack (nemotron_h) returns no caches
    and raises where they are asked for."""
    if cfg.layer_pattern:
        if want_cache:
            raise NotImplementedError(f"{cfg.name}: the pattern stack "
                                      f"trains; it has no decode cache")
        return _pattern_forward(params, cfg, x, positions, call, dtype,
                                remat), {}, 0.0
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
    ``dtype`` for the dense, moe, audio and vlm families over the stack's L
    layers, and ``pk`` / ``pv`` (n_prefix, ...) for a MoE model's dense
    prefix; with MLA the latent ``ckv`` (L, batch, cache_len, kv_lora) and
    ``kpe`` (L, batch, cache_len, rope), and ``p_ckv`` / ``p_kpe``
    (n_prefix, ...) for the prefix; for the ssm family the fp32
    ``mamba2_init_cache`` leaves stacked over L
    (``cache_len`` unused: the state does not grow with the context); for
    the hybrid that tree and ``shared_k`` / ``shared_v``, each (L // every,
    batch, cache_len, Hk, hd) in ``dtype``."""
    if cfg.layer_pattern:
        raise NotImplementedError(f"{cfg.name}: the pattern stack has no "
                                  f"decode cache")
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
    Ls = cfg.n_layers - n_prefix
    if cfg.mla:
        m = cfg.mla
        c = {}
        for key, width in (("ckv", m.kv_lora_rank),
                           ("kpe", m.qk_rope_head_dim)):
            c[key] = torch.zeros((Ls, batch, cache_len, width), dtype=dtype,
                                 device=device)
            if n_prefix:
                c["p_" + key] = torch.zeros(
                    (n_prefix, batch, cache_len, width), dtype=dtype,
                    device=device)
        return c
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros((Ls,) + shape, dtype=dtype, device=device),
         "v": torch.zeros((Ls,) + shape, dtype=dtype, device=device)}
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
    decode at pos = prompt_len. MLA's latent cache is not a ring: the
    prompt must fit (``prompt_len`` <= C), as the reference asserts."""
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
    keys, pkeys = _cache_keys(cfg)
    C = cache[keys[0]].shape[2]
    if cfg.mla:
        assert prompt_len <= C, "MLA decode cache is not a ring buffer"
    new = dict(cache)
    for key, src in zip(keys, caches["stack"]):      # (L,B,S,...)
        new[key] = _ring_place(src, C, prompt_len, axis=2).to(
            cache[key].dtype)
    if pkeys[0] in cache:
        n_prefix = cache[pkeys[0]].shape[0]
        for key, j in zip(pkeys, (0, 1)):
            src = torch.stack([caches[f"prefix{i}"][j]
                               for i in range(n_prefix)])
            new[key] = _ring_place(src, C, prompt_len, axis=2).to(
                cache[key].dtype)
    return new


def _attn_block_decode(p, cfg, x, pos, kc, vc, window, call: AttnCall,
                       dtype, mla_absorbed=True):
    """One token through an attention + FFN block (``_attn_block``'s
    decode): its K/V written into ``kc`` / ``vc`` in place; K5 under
    ``use_decode_kernel``. With MLA, ``kc`` / ``vc`` are the latent
    ``ckv`` / ``kpe`` rows and ``mla_decode`` runs (``mla_absorbed``: in
    the latent space), on tensor ops, as the reference's. A MoE FFN routes
    each row's one token on its own (capacity 8, or K under ``exact_moe``:
    never a drop); its aux is dropped, as the reference's decode drops
    it."""
    h_in = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.mla:
        h, _, _ = MLA.mla_decode(p["attn"], cfg, h_in, pos, kc, vc, dtype,
                                 absorbed=mla_absorbed)
    else:
        c = AttnCall(window=window, softcap=call.softcap,
                     use_decode_kernel=call.use_decode_kernel)
        h, _, _ = Lyr.attention_decode(p["attn"], cfg, h_in, pos, kc, vc, c,
                                       dtype)
    x = x + h
    f, _ = _ffn(p["ffn"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps), call,
                dtype)
    return x + f


def decode(params, cfg: ModelConfig, x, pos, cache, call: AttnCall, dtype,
           mla_absorbed=True):
    """x (B,1,d), pos an int or a (B,) per-slot tensor -> (y (B,1,d),
    cache). The new token's K/V (dense; MLA's latent c_kv and k_pe; the
    hybrid's shared block, in its application's row) and the recurrent
    state and conv tails (ssm and hybrid; the mamba step does not read
    ``pos``) are written into ``cache`` in place, layer by layer; the same
    dict is returned. A MoE model's dense prefix blocks run first on ``pk``
    / ``pv`` (MLA: ``p_ckv`` / ``p_kpe``) at ``call.window`` (the
    reference's). ``mla_absorbed`` picks MLA's decode path."""
    keys, pkeys = _cache_keys(cfg)
    for i, bp in enumerate(params.get("prefix", [])):
        x = _attn_block_decode(bp, cfg, x, pos, cache[pkeys[0]][i],
                               cache[pkeys[1]][i], call.window, call, dtype,
                               mla_absorbed)
    Ls = cfg.n_layers - _n_prefix(cfg)
    wins = layer_windows(cfg, Ls, call.force_window)
    layers = zip(_layers(params["stack"], Ls), wins)
    if not _is_ssm(cfg):
        for i, (bp, win) in enumerate(layers):
            x = _attn_block_decode(bp, cfg, x, pos, cache[keys[0]][i],
                                   cache[keys[1]][i], win, call, dtype,
                                   mla_absorbed)
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
