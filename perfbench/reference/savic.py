"""SAVIC rounds (the paper's Algorithm 1) in plain PyTorch, one client at
a time: H local steps on each of M clients, each step

    D ← β_t·D + (1 − β_t)·stat      (local scaling: every step)
    m ← β₁·m + g,   x ← x − γ·(m / D̂),
    D̂ = max(α, √D) (Adam) or max(α, |D|) (OASIS)

then the sync: the mean of the clients' x and m, and under global scaling
the server's D update from the mean of the clients' last gradients, ḡ².
Adam's β_t is debiased, (β − β^{t+1}) / (1 − β^{t+1}); OASIS's is β. The
OASIS stat is the Hutchinson diagonal v ⊙ ∇²f·v with Rademacher v (one
probe a local step, drawn from the round's stream), taken here
reverse-over-reverse through the reference model; the step's gradient is
that of the same pass.

``rounds`` returns what the benchmark compares (``measures``): each
round's loss (the mean of its H·M step losses), the per-leaf norms of the
momentum and of the preconditioner's statistic after the first round, and
of the params' change after the last.
"""
from __future__ import annotations

import torch

from perfbench.reference import data, measures, rng, weights


def _grad(loss_fn, leaves, rebuild, micro, hutch_stream=None):
    """(loss, grads, v ⊙ Hv or None) at ``leaves``."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(rebuild(xs), *micro)
        if hutch_stream is None:
            g = torch.autograd.grad(loss, xs)
            return loss.detach(), list(g), None
        g = torch.autograd.grad(loss, xs, create_graph=True)
        probes = [s.rademacher(x.shape, x.device)
                  for s, x in zip(hutch_stream.split(len(xs)), xs)]
        gv = sum((gi * vi).sum() for gi, vi in zip(g, probes))
        hv = torch.autograd.grad(gv, xs)
    return loss.detach(), [gi.detach() for gi in g], \
        [v * h for v, h in zip(probes, hv)]


def _beta(kind, beta2, t, device):
    b = torch.tensor(beta2, dtype=torch.float32, device=device)
    if kind == "adam":
        tt = torch.tensor(float(t + 1), dtype=torch.float32, device=device)
        return (b - b ** tt) / (1.0 - b ** tt)
    return b


def _dhat(kind, d, alpha):
    mag = torch.sqrt(d) if kind == "adam" else torch.abs(d)
    return torch.clamp_min(mag, alpha)


def _rebuilder(keys):
    def rebuild(leaves):
        out = {}
        for path, leaf in zip(keys, leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out
    return rebuild


def rounds(cfg, job, loss_fn, spec, seed: int, n_rounds: int, device,
           ein=torch.einsum, batch_hook=None):
    """Run ``n_rounds`` SAVIC rounds from the benchmark's weights.
    ``batch_hook(tokens, labels, r) -> (tokens, labels)`` may alter a
    round's batch (a planted fault)."""
    M, H = job["clients"], job["h_local"]
    kind, local = job["preconditioner"], job["scaling"] == "local"
    gamma, beta1, alpha, beta2 = job["gamma"], job["beta1"], job["alpha"], \
        job["beta2"]
    hutch = kind == "oasis"
    if (kind, local) not in (("adam", False), ("oasis", True)):
        raise ValueError(f"the reference runs adam with global scaling and "
                         f"oasis with local scaling, not {kind} "
                         f"({job['scaling']})")
    leaves = weights.paths(weights.make(spec, seed, device))
    keys = [p for p, _ in leaves]
    x = [leaf for _, leaf in leaves]
    del leaves
    rebuild = _rebuilder(keys)
    f = lambda params, tok, lab: loss_fn(params, tok, lab, cfg, ein)
    mom = [torch.zeros_like(v) for v in x]
    ones = lambda: [torch.ones_like(v) for v in x]
    D = [ones() for _ in range(M)] if local else ones()
    t = [0] * M if local else 0
    table = data.chains(cfg["vocab_size"], seed)
    shape = (M, H, job["batch"], job["seq"])
    out = {"losses": []}
    w = 1.0 / M
    for r in range(n_rounds):
        tok, lab = data.round_tokens(table, seed, r, shape)
        if batch_hook is not None:
            tok, lab = batch_hook(tok, lab, r)
        tok = torch.from_numpy(tok).to(device=device, dtype=torch.long)
        lab = torch.from_numpy(lab).to(device=device, dtype=torch.long)
        steps = rng.Stream(seed + 1).fold(r).split(H * M) if hutch else None
        acc_x = [torch.zeros_like(v) for v in x]
        acc_m = [torch.zeros_like(v) for v in x]
        acc_g = None if local else [torch.zeros_like(v) for v in x]
        step_loss = torch.zeros(H, M, device=device)
        for c in range(M):
            p = [v.clone() for v in x]
            mc = [v.clone() for v in mom]
            for h in range(H):
                loss, g, hv = _grad(f, p, rebuild, (tok[c, h], lab[c, h]),
                                    steps[h * M + c] if hutch else None)
                step_loss[h, c] = loss
                if local:
                    b = _beta(kind, beta2, t[c], device)
                    stat = hv if hutch else [gi * gi for gi in g]
                    D[c] = [b * di + (1.0 - b) * si
                            for di, si in zip(D[c], stat)]
                    t[c] += 1
                    del stat
                dc = D[c] if local else D
                for i in range(len(p)):
                    mc[i] = beta1 * mc[i] + g[i]
                    p[i] = p[i] - gamma * (mc[i] / _dhat(kind, dc[i], alpha))
                del hv
            for i in range(len(p)):
                acc_x[i] += p[i] * w
                acc_m[i] += mc[i] * w
                if acc_g is not None:
                    acc_g[i] += g[i] * w
            del p, mc, g
        x, mom = acc_x, acc_m
        if not local:
            b = _beta(kind, beta2, t, device)
            D = [b * di + (1.0 - b) * (gi * gi) for di, gi in zip(D, acc_g)]
            t += 1
        del acc_g
        out["losses"].append(float(step_loss.mean()))
        if r == 0:
            out["mom"] = {k: measures.sumsq64(v) ** 0.5
                          for k, v in zip(keys, mom)}
            rows = zip(*D) if local else ([d] for d in D)
            out["dstat"] = {k: measures.dstat_norm_rows(list(ds), job)
                            for k, ds in zip(keys, rows)}
    del mom, D
    x0 = [leaf for _, leaf in weights.paths(weights.make(spec, seed,
                                                         device))]
    out["change"] = {k: measures.sumsq64(a - b) ** 0.5
                     for k, a, b in zip(keys, x, x0)}
    return out
