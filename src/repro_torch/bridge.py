"""Carry the reference's parameters, engine state and decode caches into the
port.

The functions take trees of numpy arrays, as ``jax.device_get`` returns
them, and give the port's tensors, so the two packages can compute the same
thing in tests. bf16 arrays (numpy has no bf16 dtype of its own) move as
their 16-bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def _to_torch(x, device):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # (ascontiguousarray gives a 0-d array one dimension: reshape back)
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .reshape(a.shape).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_tree, device):
    """Parameter tree (numpy leaves) -> the same tree of tensors: lists
    (a MoE model's dense ``prefix`` blocks) stay lists, and the stacked
    (L, E, d, f) expert leaves carry over as they are."""
    return tree_map(lambda x: _to_torch(x, device), np_tree)


def state_from_jax(np_state, device):
    """Engine state (numpy leaves: params, mom, precond d/t, round, server
    m/v) -> the port's state dict with the same paths."""
    return tree_map(lambda x: _to_torch(x, device), np_state)


def cache_from_jax(np_cache, device):
    """Decode cache (numpy leaves: the dense and moe families' bf16 k/v
    (L, B, C, Hk, hd), and ``pk`` / ``pv`` (n_prefix, B, C, Hk, hd) for a
    MoE model's dense prefix; the ssm and hybrid families' fp32 ``mamba``
    tree, and the hybrid's bf16 ``shared_k`` / ``shared_v``) -> the port's
    cache dict, bf16 tensors with the same bits."""
    return tree_map(lambda x: _to_torch(x, device), np_cache)
