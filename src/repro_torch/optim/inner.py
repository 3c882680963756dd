"""Plain inner optimizers on trees of tensors (counterpart of
``repro/optim/inner.py``): heavy-ball SGD and AdamW, each one step that
returns new trees. Nothing in the engine calls them; they are part of the
package's API, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map


def sgd_step(params, mom, grads, lr, beta1=0.9, weight_decay=0.0):
    """m ← β₁m + (g + wd·p);  p ← p − lr·m. Returns (params, mom)."""
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    mom = tree_map(lambda m, g: beta1 * m + g, mom, grads)
    params = tree_map(lambda p, m: p - lr * m, params, mom)
    return params, mom


def adamw_step(params, m, v, grads, lr, t, beta1=0.9, beta2=0.999, eps=1e-8,
               weight_decay=0.0):
    """AdamW with bias correction at step ``t`` (a count of steps already
    taken, a tensor or an int): returns (params, m, v)."""
    m = tree_map(lambda a, g: beta1 * a + (1 - beta1) * g, m, grads)
    v = tree_map(lambda a, g: beta2 * a + (1 - beta2) * g * g, v, grads)
    tt = torch.as_tensor(t).to(torch.float32) + 1.0
    c1 = 1.0 - beta1 ** tt
    c2 = 1.0 - beta2 ** tt

    def upd(p, mi, vi):
        return p - lr * (mi / c1) / (torch.sqrt(vi / c2) + eps) \
            - lr * weight_decay * p
    params = tree_map(upd, params, m, v)
    return params, m, v
