"""Device time a round of the expert layers: the device operations
launched inside the program's ``model.moe`` span (``models/moe.
share_apply``: routing, the held experts' matmuls, the combine and the
shared expert), its remat ``.recompute`` and its ``.bwd``, in the
device-only span pass (``spans.py``), in ms a round. A program without
the span gives nothing."""
from perfbench import spans

LAYER = "model forward and backward: models/*"
MOVES = "train_tok_s"
UNIT = "ms/round"
NAMES = ("model.moe", "model.moe.recompute", "model.moe.bwd")


def read(ctx):
    p = spans.of(ctx)
    return (p.under(NAMES) or None) if p and p.read() else None
