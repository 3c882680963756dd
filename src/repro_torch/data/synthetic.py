"""Synthetic LM data (numpy copy of ``TokenStream`` from
``repro/data/synthetic.py``; batches must stay byte-identical to it)."""
from __future__ import annotations

import numpy as np


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
