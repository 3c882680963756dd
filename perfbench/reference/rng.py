"""A frozen copy of the stream algorithm that the program's round draws
from (an address ``(seed, path)`` hashed with blake2b into the seed of a
fresh ``torch.Generator`` on the draw's device), so that the reference
draws the same Rademacher probes. Only what the benchmark's methods draw
is kept: ``fold``, ``split`` and ``rademacher``.

Round r's stream is ``Stream(seed + 1).fold(r)``; a round with local
Hutchinson probes splits it into H·M step streams, row-major over (h, m);
a probe splits the step stream into one stream per parameter leaf, in the
order of the sorted leaf paths.
"""
from __future__ import annotations

import hashlib

import torch


class Stream:
    def __init__(self, seed: int, path: tuple = ()):
        self.seed = int(seed)
        self.path = tuple(path)

    def fold(self, c: int) -> "Stream":
        return Stream(self.seed, self.path + (("fold", int(c)),))

    def split(self, n: int) -> list:
        return [Stream(self.seed, self.path + (("split", int(n), i),))
                for i in range(int(n))]

    def generator(self, device) -> torch.Generator:
        digest = hashlib.blake2b(repr((self.seed, self.path)).encode(),
                                 digest_size=8).digest()
        seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
        return torch.Generator(device=device).manual_seed(seed)

    def rademacher(self, shape, device) -> torch.Tensor:
        out = torch.empty(tuple(shape), device=device, dtype=torch.float32)
        return out.bernoulli_(0.5, generator=self.generator(device)) \
            .mul_(2.0).sub_(1.0)
