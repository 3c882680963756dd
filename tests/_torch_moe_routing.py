"""Routing records of the port's MoE layers and the near-tie rule between
two routes' routing (torch only: the MoE tests and ``chip_smoke.py`` phase
12 use it).

``RouteRecorder`` wraps ``repro_torch.models.moe._route`` while it is
installed and keeps, for every call, the router's fp32 probabilities, the
top-K expert ids, keep and slot; the port itself has no recording knob.

``hold_routing`` compares two records of the same tokens, call by call
(one call a MoE layer, in layer order). A token's routing differs in a
layer where its set of K experts differs. Routing is discontinuous: two
implementations whose router probabilities differ by ε may choose other
experts for a token whose K-th and (K+1)-th probabilities lie within 2ε,
and such a token's later layers, and the ranks of later tokens in the
experts it moved between, then differ too. So each token's first
difference must be a near tie: its top-K margin in the reference record
(``b``) at most ``factor``·ε, with ε the largest probability difference
in that layer over the tokens whose routing has agreed in every layer so
far. A layer with no differing token must agree on each choice's keep
and slot, matched by expert (a token's picks may come in another order),
bit for bit. No tolerance on the outputs is widened for a flip.
"""
from __future__ import annotations

import torch


class RouteRecorder:
    """Context manager: records every ``moe._route`` call of the port."""

    def __init__(self, moe_module, min_tokens=1):
        self.mod, self.min_tokens, self.calls = moe_module, min_tokens, []

    def __enter__(self):
        self.real = self.mod._route
        self.mod._route = self
        return self

    def __exit__(self, *exc):
        self.mod._route = self.real

    def __call__(self, p, cfg, x, C):
        out = self.real(p, cfg, x, C)
        if x.shape[1] >= self.min_tokens:
            probs, _, eidx, _, keep, slot, _, _ = out
            self.calls.append({"probs": probs.detach().float(),
                               "eidx": eidx, "keep": keep, "slot": slot,
                               "C": C})
        return out


def _by_expert(rec, device):
    """A record's expert ids, keep and slot, each (G, N, K), with each
    token's K choices in expert order: two routes may order a token's
    picks differently (two of its top-K probabilities within rounding of
    each other) with the same set, ranks and slots."""
    e = rec["eidx"].to(device)
    G, N, K = e.shape
    e, order = torch.sort(e, dim=-1)
    keep = rec["keep"].to(device).reshape(G, N, K).gather(-1, order)
    slot = rec["slot"].to(device).reshape(G, N, K).gather(-1, order)
    return e, keep, slot


def top_k_margin(probs, K):
    """p_(K) - p_(K+1) of each token's sorted probabilities (inf at K=E)."""
    s = torch.sort(probs, dim=-1, descending=True).values
    if K >= s.shape[-1]:
        return torch.full(s.shape[:-1], float("inf"), device=s.device)
    return s[..., K - 1] - s[..., K]


def hold_routing(a, b, K, factor=4.0, live=None):
    """Hold record ``a`` (list of calls) against ``b``, the reference, of
    the same tokens; ``live`` (bool (G,)) leaves out the groups (batch
    rows) whose routing parted in an earlier call. Returns a summary dict:
    ``flips`` (token-layers whose expert set differs), ``first`` (tokens'
    first differences, each a near tie), ``worst`` (the largest ratio of a
    first difference's margin to its bound), ``eps`` (per layer),
    ``keep_diff`` (choices kept in one record and dropped in the other),
    ``layer_rows`` (per layer, bool (G,): the groups with a difference
    there) and ``rows`` (the groups with a difference in some layer).
    Raises AssertionError where a first difference is not a near tie, or
    where a layer with no difference disagrees on keep or slot."""
    assert len(a) == len(b), (len(a), len(b))
    ever = on = None
    out = {"flips": 0, "first": 0, "worst": 0.0, "eps": [],
           "keep_diff": 0, "margins": [], "layer_rows": []}
    for i, (ra, rb) in enumerate(zip(a, b)):
        pa, pb = ra["probs"].to(rb["probs"].device), rb["probs"]
        ea, ka, sa = _by_expert(ra, pb.device)
        eb, kb, sb = _by_expert(rb, pb.device)
        assert pa.shape == pb.shape and ea.shape == eb.shape, i
        G, N = pb.shape[:2]
        if ever is None:
            on = torch.ones(G, dtype=torch.bool, device=pb.device) \
                if live is None else live.to(pb.device)
            ever = (~on)[:, None].expand(G, N).clone()
        diff = (ea != eb).any(-1) & on[:, None]
        first = diff & ~ever
        dp = (pa - pb).abs().amax(-1)
        clean = ~ever & ~diff
        eps = float(dp[clean].max()) if bool(clean.any()) else 0.0
        out["eps"].append(eps)
        n_first = int(first.sum())
        if n_first:
            m = top_k_margin(pb, K)[first]
            bound = factor * eps
            ratio = float(m.max()) / bound if bound > 0 else float("inf")
            out["worst"] = max(out["worst"], ratio)
            out["margins"] += [float(v) for v in m]
            assert ratio <= 1.0, (
                f"layer {i}: a token's routing differs with top-K margin "
                f"{float(m.max()):.3e} > {factor}·eps = {bound:.3e}")
        ka, kb, sa, sb = ka[on], kb[on], sa[on], sb[on]
        if not bool(diff.any()):
            assert torch.equal(ka, kb) and torch.equal(sa, sb), \
                f"layer {i}: equal expert sets, different keep or slot"
        out["keep_diff"] += int((ka != kb).sum())
        out["flips"] += int(diff.sum())
        out["first"] += n_first
        out["layer_rows"].append(diff.any(-1))
        ever |= diff
    rows = torch.stack(out["layer_rows"]).any(0) if out["layer_rows"] \
        else torch.zeros(0, dtype=torch.bool)
    out["rows"] = [int(r) for r in torch.nonzero(rows).flatten()]
    return out
