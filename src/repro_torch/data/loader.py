"""Round batches for LM training (numpy copy of ``LMRoundLoader`` from
``repro/data/loader.py``)."""
from __future__ import annotations


class LMRoundLoader:
    """``round_batch(r, ...)`` is a pure function of (stream seed, r, M, H, b,
    S): all M·H·b sequences come from one ``TokenStream.batch_at`` draw, so a
    run restarted at round r draws round-r data. The reference's
    ``labeled_frac`` mask belongs to the semi-supervised objectives, which are
    not ported yet."""

    def __init__(self, stream, n_clients: int, batch_size: int):
        self.stream = stream
        self.M = n_clients
        self.b = batch_size

    def round_batch(self, r: int, H: int, seq_len: int):
        """{"tokens", "labels"}: int32 numpy arrays (M, H, b, S)."""
        toks, labs = self.stream.batch_at(r, self.M * H * self.b, seq_len)
        shape = (self.M, H, self.b, seq_len)
        return {"tokens": toks.reshape(shape), "labels": labs.reshape(shape)}
