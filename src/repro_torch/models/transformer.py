"""Decoder stack, dense family (counterpart of
``repro/models/transformer.py``).

Block parameters are stacked with a leading L dim, as in the reference tree
(``{"stack": {...}}``). Where the reference scans over layers under
``jax.checkpoint``, this loops over them in Python and wraps each layer in
``torch.utils.checkpoint`` (``remat``), so only layer inputs are kept for the
backward pass.
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
from repro_torch.models.layers import AttnCall, init_rmsnorm, mlp, rmsnorm
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _init_block(gen, cfg: ModelConfig):
    d = cfg.d_model
    return {"norm1": init_rmsnorm(d, gen.device),
            "norm2": init_rmsnorm(d, gen.device),
            "attn": Lyr.init_attention(gen, cfg),
            "ffn": Lyr.init_mlp(gen, d, cfg.d_ff)}


def init_stack(gen, cfg: ModelConfig):
    """All stack params: per-block leaves stacked with a leading L dim."""
    if cfg.family != "dense":
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet")
    blocks = [_init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return {"stack": tree_map(lambda *xs: torch.stack(xs), *blocks)}


def _block_fwd(bp, cfg, x, positions, call: AttnCall, dtype):
    h_in = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    x = x + Lyr.attention(bp["attn"], cfg, h_in, positions, call, dtype)
    f_in = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + mlp(bp["ffn"], f_in, cfg.act, dtype)


def forward(params, cfg: ModelConfig, x, positions, call: AttnCall, dtype,
            remat=True):
    """x (B,S,d) residual stream -> y (B,S,d)."""
    stack = params["stack"]
    # unbind once per leaf: its backward stacks the L layer grads in one
    # buffer (indexing per layer would allocate a full (L, ...) zero tensor
    # for every layer's grad)
    per_leaf = [leaf.unbind(0) for leaf in tree_leaves(stack)]
    for i in range(cfg.n_layers):
        bp = tree_unflatten(stack, [layers[i] for layers in per_leaf])
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block_fwd, bp, cfg, x, positions, call, dtype,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_fwd(bp, cfg, x, positions, call, dtype)
    return x
