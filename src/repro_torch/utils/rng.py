"""The port's rng interface: every random draw of a round goes through a
*stream* (counterpart of the reference's ``jax.random`` key discipline).

A stream is an address, not a state. It has six methods:

  ``fold(c)``                  the stream for one named purpose (a constant);
  ``split(n)``                 n independent child streams, as a list;
  ``uniform(shape, device)``   fp32 draws in [0, 1);
  ``rademacher(shape, device)`` fp32 draws of ±1;
  ``permutation(n, device)``   an int64 permutation of range(n);
  ``gumbel(shape, device)``    fp32 standard Gumbel draws (as
                               ``jax.random.gumbel``).

Drawing twice from one stream gives the same numbers, as reusing a JAX key
does; a caller folds or splits first. The engine's draws use the reference's
fold constants below and its per-step ``split`` of the round stream into
H·M streams (row-major over (h, m)). Serving's sampling noise chains
``nxt, draw = stream.split(2)`` per step from ``TorchStream(seed + 2)``, as
the reference's ``key, k = split(key)`` from ``PRNGKey(seed + 2)``.

``TorchStream`` is the production stream. It is derived from ``(seed,
path)`` alone, where the path is the sequence of folds and splits that led to
it, and never from a count of earlier draws: round r's stream is
``TorchStream(seed + 1).fold(r)`` (as the reference's ``fold_in(PRNGKey(seed
+ 1), r)``), so a resumed run replays round r. Each draw seeds a fresh
``torch.Generator`` on the draw's device from a hash of that address. Its
numbers are not the reference's: the tests replay the reference's streams
through the same interface (``tests/_torch_rng_replay.py``).
"""
from __future__ import annotations

import hashlib

import torch

# fold constants of the reference round (repro/core/engine.py)
PARTICIPATION_FOLD = 3     # participation_weights: the sampled subset
HUTCHINSON_FOLD = 7        # the sync-time Hutchinson probe (global D)
OBJECTIVE_FOLD = 11        # client objectives' noise (no draw ported yet)
COMPRESSION_FOLD = 17      # compress_tree: one split per leaf


class TorchStream:
    """A round-addressable stream on ``torch.Generator``."""

    def __init__(self, seed: int, path: tuple = ()):
        self.seed = int(seed)
        self.path = tuple(path)

    def fold(self, c: int) -> "TorchStream":
        return TorchStream(self.seed, self.path + (("fold", int(c)),))

    def split(self, n: int) -> list:
        return [TorchStream(self.seed, self.path + (("split", int(n), i),))
                for i in range(int(n))]

    def _generator(self, device) -> torch.Generator:
        digest = hashlib.blake2b(repr((self.seed, self.path)).encode(),
                                 digest_size=8).digest()
        seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
        return torch.Generator(device=device).manual_seed(seed)

    def uniform(self, shape, device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._generator(device),
                          device=device, dtype=torch.float32)

    def rademacher(self, shape, device) -> torch.Tensor:
        out = torch.empty(tuple(shape), device=device, dtype=torch.float32)
        return out.bernoulli_(0.5, generator=self._generator(device)) \
            .mul_(2.0).sub_(1.0)

    def permutation(self, n: int, device="cpu") -> torch.Tensor:
        return torch.randperm(int(n), generator=self._generator(device),
                              device=device, dtype=torch.int64)

    def gumbel(self, shape, device) -> torch.Tensor:
        return gumbel_from_uniform(self.uniform(shape, device))


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) on U[0, 1) draws, in place. u is first raised to the
    smallest normal fp32 (as ``jax.random.gumbel`` draws u in [tiny, 1)), so
    every draw is finite: u = 0 gives -4.47, the largest u < 1 gives 16.6."""
    return u.clamp_(min=torch.finfo(torch.float32).tiny).log_().neg_() \
        .log_().neg_()


def step_streams(stream, H: int, M: int) -> list:
    """The per-step streams of a round, ``[h][m]``: one ``split(H·M)``,
    row-major, as the reference's ``split(key, (H, M))``."""
    flat = stream.split(H * M)
    return [flat[h * M:(h + 1) * M] for h in range(H)]
