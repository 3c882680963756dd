"""Device time a round of the chunked SSD scan: the device operations
launched inside the program's ``model.ssd`` span (``models/ssm.
ssd_chunked``, its chunk loop included), its remat ``.recompute`` and its
``.bwd``, in the device-only span pass (``spans.py``), in ms a round."""
from perfbench import spans

LAYER = "model forward and backward: models/*"
MOVES = "train_tok_s"
UNIT = "ms/round"
NAMES = ("model.ssd", "model.ssd.recompute", "model.ssd.bwd")


def read(ctx):
    p = spans.of(ctx)
    return (p.under(NAMES) or None) if p and p.read() else None
