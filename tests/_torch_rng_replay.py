"""Test-side stream that replays the reference's ``jax.random`` draws through
the port's rng interface (``repro_torch.utils.rng``).

``JaxStream`` wraps one JAX key. ``fold``/``split`` are
``jax.random.fold_in``/``split``; the draws are ``jax.random.uniform``,
``normal``, ``rademacher``, ``randint`` (int32 draws, as the reference draws
token ids), ``permutation`` and ``gumbel`` on that key, returned as torch
tensors. A port round (or serve loop) driven by a ``JaxStream`` sees
the very numbers the reference draws from the same key, so the two
trajectories can be compared value by value.
"""
from __future__ import annotations

import jax
import numpy as np
import torch


class JaxStream:
    def __init__(self, key):
        self.key = key

    def fold(self, c: int) -> "JaxStream":
        return JaxStream(jax.random.fold_in(self.key, int(c)))

    def split(self, n: int) -> list:
        return [JaxStream(k) for k in jax.random.split(self.key, int(n))]

    def uniform(self, shape, device) -> torch.Tensor:
        a = np.asarray(jax.random.uniform(self.key, tuple(shape)))
        return torch.from_numpy(a.copy()).to(device)

    def normal(self, shape, device) -> torch.Tensor:
        a = np.asarray(jax.random.normal(self.key, tuple(shape)))
        return torch.from_numpy(a.copy()).to(device)

    def rademacher(self, shape, device) -> torch.Tensor:
        a = np.asarray(jax.random.rademacher(self.key, tuple(shape),
                                             np.float32))
        return torch.from_numpy(a.copy()).to(device)

    def randint(self, shape, lo: int, hi: int, device) -> torch.Tensor:
        a = np.asarray(jax.random.randint(self.key, tuple(shape), int(lo),
                                          int(hi), np.int32))
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def permutation(self, n: int, device="cpu") -> torch.Tensor:
        a = np.asarray(jax.random.permutation(self.key, int(n)))
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def gumbel(self, shape, device) -> torch.Tensor:
        a = np.asarray(jax.random.gumbel(self.key, tuple(shape), np.float32))
        return torch.from_numpy(a.copy()).to(device)
