"""Device time a round of the attention core: the device operations
launched inside the program's ``model.attention`` span (scores, mask,
softmax and weighted sum in ``models/layers.attention``), its remat
``.recompute`` and its ``.bwd``, in the device-only span pass
(``spans.py``), in ms a round."""
from perfbench import spans

LAYER = "model forward and backward: models/*"
MOVES = "train_tok_s"
UNIT = "ms/round"
NAMES = ("model.attention", "model.attention.recompute",
         "model.attention.bwd")


def read(ctx):
    p = spans.of(ctx)
    return (p.under(NAMES) or None) if p and p.read() else None
