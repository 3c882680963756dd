"""A frozen copy of the synthetic token stream the program trains on: a
mixture of order-2 Markov chains over the vocabulary, each batch a pure
function of (seed, round), so the reference draws round r's tokens again
without the program's loader.
"""
from __future__ import annotations

import numpy as np

N_CHAINS = 4
BRANCHES = 8


def chains(vocab: int, seed: int) -> np.ndarray:
    """The (N_CHAINS, vocab, BRANCHES) int32 transition table of the
    stream with this seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(N_CHAINS, vocab, BRANCHES),
                        dtype=np.int32)


def round_tokens(table: np.ndarray, seed: int, r: int, shape):
    """Round ``r``'s (tokens, labels), int32 arrays of ``shape`` (M, H, b,
    S): M·H·b chain walks of S + 1 tokens, labels the next token."""
    M, H, b, S = shape
    n, vocab = M * H * b, table.shape[1]
    rng = np.random.default_rng((seed, int(r)))
    cid = rng.integers(table.shape[0], size=n)
    start = rng.integers(vocab, size=n)
    branch = rng.integers(BRANCHES, size=(n, S))
    walk = np.empty((n, S + 1), dtype=np.int32)
    walk[:, 0] = start
    for s in range(S):
        walk[:, s + 1] = table[cid, walk[:, s], branch[:, s]]
    return walk[:, :-1].reshape(shape), walk[:, 1:].reshape(shape)
