"""Synthetic datasets (numpy copies of ``repro/data/synthetic.py``; every
array must stay byte-identical to the reference's for a seed).

* ``ClassificationData`` — CIFAR-shaped images with class-dependent Gaussian
  prototypes + noise, the stand-in for CIFAR-10 in the paper's Fig. 1
  experiment (with the main-class partitioner).
* ``QuadraticProblem`` — strongly-convex quadratics with controllable μ, L,
  gradient noise σ² and client heterogeneity: the setting where Theorems 1-2
  are quantitatively falsifiable.
* ``TokenStream`` — deterministic pseudo-token LM stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClassificationData:
    x: np.ndarray           # (N, D) float32
    y: np.ndarray           # (N,) int32
    n_classes: int

    @staticmethod
    def make(n=20_000, shape=(8, 8, 3), n_classes=10, noise=1.0, seed=0):
        rng = np.random.default_rng(seed)
        D = int(np.prod(shape))
        protos = rng.normal(size=(n_classes, D)).astype(np.float32)
        protos /= np.linalg.norm(protos, axis=1, keepdims=True)
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        x = 2.0 * protos[y] + noise * rng.normal(size=(n, D)).astype(np.float32)
        # second-order structure so adaptivity has something to exploit
        scales = np.exp(rng.uniform(-2, 2, size=D)).astype(np.float32)
        x = x * scales[None, :]
        return ClassificationData(x=x.astype(np.float32), y=y,
                                  n_classes=n_classes)


@dataclasses.dataclass
class QuadraticProblem:
    """f_m(x) = 0.5 (x-b_m)ᵀ Q_m (x-b_m); stochastic grads add N(0, σ²/d I).

    heterogeneity h shifts each client's optimum b_m by h·unit vectors; h=0
    gives the identical-data regime (all f_m equal).
    """
    Q: np.ndarray            # (M, d, d)
    b: np.ndarray            # (M, d)
    sigma: float
    mu: float
    L: float

    @staticmethod
    def make(d=50, M=8, mu=0.1, L=10.0, sigma=1.0, heterogeneity=0.0, seed=0):
        rng = np.random.default_rng(seed)
        Qs, bs = [], []
        # shared eigenbasis, per-client spectra within [mu, L]
        A = rng.normal(size=(d, d))
        U, _ = np.linalg.qr(A)
        center = rng.normal(size=d)     # common optimum (x0=0 is NOT optimal)
        for m in range(M):
            eig = np.exp(rng.uniform(np.log(mu), np.log(L), size=d))
            eig[0], eig[-1] = mu, L     # pin extremes
            Qs.append((U * eig) @ U.T)
            shift = heterogeneity * rng.normal(size=d) / np.sqrt(d)
            bs.append(center + shift)
        return QuadraticProblem(Q=np.stack(Qs).astype(np.float64),
                                b=np.stack(bs).astype(np.float64),
                                sigma=sigma, mu=mu, L=L)

    def x_star(self):
        """argmin of the average objective: (ΣQ_m)^{-1} ΣQ_m b_m."""
        Qbar = self.Q.mean(0)
        rhs = np.einsum("mij,mj->i", self.Q, self.b) / self.Q.shape[0]
        return np.linalg.solve(Qbar, rhs)

    def sigma_dif2(self):
        """σ²_dif = (1/M) Σ E‖∇f_m(x*, z)‖² at the global optimum."""
        xs = self.x_star()
        g2 = [np.sum((self.Q[m] @ (xs - self.b[m])) ** 2)
              for m in range(self.Q.shape[0])]
        return float(np.mean(g2) + self.sigma ** 2)


class TokenStream:
    """Deterministic synthetic LM data: tokens from a mixture of order-2
    Markov chains (so a real model can reduce loss well below uniform).

    ``batch_at`` is stateless and round-addressable: batch ``index`` is a pure
    function of (stream seed, index, shapes).
    """

    def __init__(self, vocab_size: int, seed: int = 0, n_chains: int = 4):
        self.vocab = vocab_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        # stacked sparse transition structure: (n_chains, vocab, 8)
        self.chains = rng.integers(0, vocab_size,
                                   size=(n_chains, vocab_size, 8),
                                   dtype=np.int32)

    def _walk(self, rng, batch_size: int, seq_len: int):
        """(B, S+1) chain walk: per-sequence chain id, vectorized over B."""
        cid = rng.integers(self.chains.shape[0], size=batch_size)
        start = rng.integers(self.vocab, size=batch_size)
        branch = rng.integers(8, size=(batch_size, seq_len))
        out = np.empty((batch_size, seq_len + 1), dtype=np.int32)
        out[:, 0] = start
        for s in range(seq_len):
            out[:, s + 1] = self.chains[cid, out[:, s], branch[:, s]]
        return out

    def batch_at(self, index: int, batch_size: int, seq_len: int):
        """Batch ``index`` of the stream: (tokens, labels) int32 (B, S),
        labels = next token."""
        rng = np.random.default_rng((self.seed, int(index)))
        out = self._walk(rng, batch_size, seq_len)
        return out[:, :-1], out[:, 1:]
