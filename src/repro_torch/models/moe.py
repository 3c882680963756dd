"""Top-k routed Mixture-of-Experts with a shared MLP (counterpart of
``repro/models/moe.py``; Qwen-MoE style).

Dispatch is sort-based with a static per-expert capacity C, the
reference's GShard semantics: each routed choice is ranked within its
expert by a stable argsort over the expert ids (so by token index: a token
picks an expert at most once), scattered into an (E, C, d) capacity
buffer, run through the stacked experts (``torch.einsum``, a batched GEMM
over E), and combined back with the renormalised router weights. Choices
ranked C or later are dropped.

``grouped`` (the default) routes each batch row on its own with its own
capacity, as the reference does: padding rows, a continuous-batching
ring's other slots and a static batch's repeated members never change a
request's routing. The rows are batched tensor ops over one
``(B·(E·C+1), d)`` buffer (row b's slots start at b·(E·C+1); its last row
is the drop bin), not a loop. The flat variant routes all B·S tokens as
one group.

The top-k is a stable descending sort, so ties go to the lower expert
index, as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
order). The combine sums each token's K contributions in k order, starting
from the first, in ``dtype`` (the reference's ``.at[token_of].add``): no
``index_add_``, whose atomics on the card would make a serve's ids differ
from run to run. The reference's sharding hook (``shard``) belongs to the
multi-device layer and is not carried.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import (_dense_init, _normal, init_mlp,
                                       linear, mlp)


def init_moe(gen, cfg: ModelConfig):
    """Router ``{"w": (d, E)}`` (no bias), stacked experts ``wg`` / ``wu``
    (E, d, f) and ``wd`` (E, f, d), and the shared MLP of width
    ``d_ff_shared`` where ``n_shared``; the reference's tree and scales."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {"router": _dense_init(gen, d, E),
         "experts": {"wg": _normal(gen, (E, d, f), d ** -0.5),
                     "wu": _normal(gen, (E, d, f), d ** -0.5),
                     "wd": _normal(gen, (E, f, d), f ** -0.5)}}
    if m.n_shared:
        p["shared"] = init_mlp(gen, d, m.d_ff_shared)
    return p


def _capacity(n_tokens, m):
    """The reference's capacity: tokens·K·factor/E truncated, then up to a
    multiple of 8, at least 8 (2048 tokens of qwen2-moe: 176; 256: 24;
    one: 8)."""
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _route(p, cfg: ModelConfig, x, C):
    """Route the tokens of each group of x (G, N, d) to the capacity
    buffer. Returns fp32 ``probs`` (G, N, E) and ``gate`` (G, N, K)
    (renormalised over the K picks), int64 ``eidx`` (G, N, K), the rank of
    each choice within its expert ``rank`` (G, N·K) (in flat token-major
    order), ``keep`` (rank < C), ``slot`` (e·C + rank, or E·C: the drop
    bin), the choices per expert ``counts`` (G, E), and the Switch-style
    load-balance loss ``aux`` (G,)."""
    m = cfg.moe
    G, N, _ = x.shape
    E, K = m.n_experts, m.top_k
    logits = linear(p["router"], x, torch.float32)            # (G, N, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = vals[..., :K], idx[..., :K]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    flat_e = eidx.reshape(G, N * K)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    density = counts.float() / (N * K)
    aux = m.router_aux_weight * E * (density * probs.mean(dim=1)).sum(-1)

    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    starts = torch.cumsum(counts, dim=1) - counts             # exclusive
    ar = torch.arange(N * K, device=x.device).expand(G, N * K)
    rank = torch.empty_like(flat_e).scatter_(
        1, order, ar - starts.gather(1, sorted_e))
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, torch.full_like(rank, E * C))
    return probs, gate, eidx, rank, keep, slot, counts, aux


def _dispatch(p, cfg: ModelConfig, x, dtype, C):
    """x (G, N, d) -> (hidden (G, E, C, d), slot, keep, w (G, N·K), aux
    (G,)): each group's kept choices written into its (E·C, d) rows of one
    buffer, the token's row in ``dtype``; empty slots are zero."""
    m = cfg.moe
    G, N, d = x.shape
    E, K = m.n_experts, m.top_k
    _, gate, _, _, keep, slot, _, aux = _route(p, cfg, x, C)
    rows = E * C + 1
    base = torch.arange(G, device=x.device)[:, None] * rows
    src = x.to(dtype).repeat_interleave(K, dim=1)               # (G, N·K, d)
    buf = x.new_zeros((G * rows, d), dtype=dtype).index_put(
        ((slot + base).reshape(-1),), src.reshape(-1, d))
    hidden = buf.view(G, rows, d)[:, :E * C].reshape(G, E, C, d)
    w = (gate.reshape(G, N * K) * keep).to(dtype)
    return hidden, slot, keep, w, aux


def _combine(out, slot, keep, w, K):
    """out (G, E, C, d) expert outputs -> per-token sums (G, N, d): each
    choice's row (zero where dropped) times its weight, the K choices of a
    token added in k order."""
    G, E, C, d = out.shape
    flat = out.reshape(G, E * C, d)
    picked = flat.gather(1, torch.clamp_max(slot, E * C - 1)[..., None]
                         .expand(-1, -1, d))
    picked = torch.where(keep[..., None], picked, 0.0) * w[..., None]
    picked = picked.reshape(G, -1, K, d)
    y = picked[:, :, 0]
    for k in range(1, K):
        y = y + picked[:, :, k]
    return y


def _expert_ffn(p, hidden, act, dtype):
    """hidden (G, E, C, d) -> (G, E, C, d) through the stacked experts."""
    we = p["experts"]
    g = torch.einsum("gecd,edf->gecf", hidden, we["wg"].to(dtype))
    u = torch.einsum("gecd,edf->gecf", hidden, we["wu"].to(dtype))
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", a * u, we["wd"].to(dtype))


def moe_apply(p, cfg: ModelConfig, x, act, dtype, capacity=None,
              no_drop=False, grouped=True):
    """x (B, S, d) -> (y (B, S, d), aux fp32 scalar).

    ``grouped``: each batch row routed on its own at capacity
    ``_capacity(S)`` (aux the mean over rows); else the B·S tokens as one
    group at ``_capacity(B·S)``. ``capacity`` overrides C; ``no_drop``
    sets C = tokens·K (the reference's ``exact_moe``)."""
    m = cfg.moe
    B, S, d = x.shape
    xg = x if grouped else x.reshape(1, B * S, d)
    N = xg.shape[1]
    C = N * m.top_k if no_drop else (capacity or _capacity(N, m))
    hidden, slot, keep, w, aux = _dispatch(p, cfg, xg, dtype, C)
    out = _expert_ffn(p, hidden, act, dtype)
    y = _combine(out, slot, keep, w, m.top_k).reshape(B, S, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x, act, dtype)
    return y, aux.mean()
