"""Client-sharded round batches (numpy copies of ``repro/data/loader.py``;
the same rng sequence, hence byte-identical batches).

A round consumes a batch whose leaves are (M, H, b, ...): H local
microbatches of size b for each of M clients. ``FederatedLoader`` wraps a
dataset and a partition, ``QuadraticLoader`` draws the gradient noise of a
``QuadraticProblem``, ``LMRoundLoader`` cuts token streams.
"""
from __future__ import annotations

import numpy as np


class FederatedLoader:
    """Round batches from a dataset ``x``, ``y`` and a partition ``parts``
    (one index array per client), each client's microbatches drawn with
    replacement from its own indices. ``labeled`` is an optional float32 0/1
    array over the dataset (``federated.labeled_mask``); when given, round
    batches carry a ``"labeled"`` (M, H, b) leaf for the semi-supervised
    client objectives."""

    def __init__(self, x, y, parts, batch_size: int, seed: int = 0,
                 labeled=None):
        self.x, self.y = x, y
        self.parts = parts
        self.b = batch_size
        self.labeled = labeled
        self.rng = np.random.default_rng(seed)

    @property
    def n_clients(self):
        return len(self.parts)

    def round_batch(self, H: int):
        """{"x": (M, H, b, D), "y": (M, H, b)[, "labeled": (M, H, b)]} numpy
        arrays."""
        M, b = self.n_clients, self.b
        xs = np.empty((M, H, b) + self.x.shape[1:], dtype=self.x.dtype)
        ys = np.empty((M, H, b), dtype=self.y.dtype)
        lab = (np.empty((M, H, b), dtype=np.float32)
               if self.labeled is not None else None)
        for m, idx in enumerate(self.parts):
            pick = self.rng.choice(idx, size=(H, b), replace=True)
            xs[m] = self.x[pick]
            ys[m] = self.y[pick]
            if lab is not None:
                lab[m] = self.labeled[pick]
        out = {"x": xs, "y": ys}
        if lab is not None:
            out["labeled"] = lab
        return out


class QuadraticLoader:
    """Noise-only 'batches' for ``QuadraticProblem``: each microbatch is a
    noise vector z added to the gradient (Assumption 2 with variance σ²) and
    the client id that picks f_m."""

    def __init__(self, problem, seed: int = 0):
        self.p = problem
        self.rng = np.random.default_rng(seed)

    def round_batch(self, H: int):
        """{"z": (M, H, d) float32, "cid": (M, H) int32} numpy arrays."""
        M, d = self.p.b.shape
        z = self.rng.normal(size=(M, H, d)) * (self.p.sigma / np.sqrt(d))
        cid = np.broadcast_to(np.arange(M, dtype=np.int32)[:, None], (M, H))
        return {"z": z.astype(np.float32), "cid": np.ascontiguousarray(cid)}


class LMRoundLoader:
    """``round_batch(r, ...)`` is a pure function of (stream seed, r, M, H, b,
    S): all M·H·b sequences come from one ``TokenStream.batch_at`` draw, so a
    run restarted at round r draws round-r data. With ``labeled_frac`` < 1 a
    per-sequence ``"labeled"`` (M, H, b) float32 mask joins the batch, drawn
    from ``default_rng([seed, 24593, r])`` (round-addressable too); at 1 there
    is no such leaf."""

    def __init__(self, stream, n_clients: int, batch_size: int,
                 labeled_frac: float = 1.0, seed: int = 0):
        self.stream = stream
        self.M = n_clients
        self.b = batch_size
        self.labeled_frac = labeled_frac
        self.seed = seed

    def round_batch(self, r: int, H: int, seq_len: int):
        """{"tokens", "labels"}: int32 numpy arrays (M, H, b, S)[, "labeled":
        float32 (M, H, b)]."""
        toks, labs = self.stream.batch_at(r, self.M * H * self.b, seq_len)
        shape = (self.M, H, self.b, seq_len)
        out = {"tokens": toks.reshape(shape), "labels": labs.reshape(shape)}
        if self.labeled_frac < 1.0:
            rng = np.random.default_rng([self.seed, 24593, r])
            lab = rng.random((self.M, H, self.b)) < self.labeled_frac
            out["labeled"] = lab.astype(np.float32)
        return out
