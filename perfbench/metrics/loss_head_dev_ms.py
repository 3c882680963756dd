"""Device time a round of the loss head: the device operations launched
inside the program's ``model.loss_head`` span (final norm, unembed, cross
entropy in ``models/model.loss``) and its ``.bwd``, in the device-only
span pass (``spans.py``), in ms a round."""
from perfbench import spans

LAYER = "model forward and backward: models/*"
MOVES = "train_tok_s"
UNIT = "ms/round"


def read(ctx):
    p = spans.of(ctx)
    return p.under(["model.loss_head", "model.loss_head.bwd"]) \
        if p and p.read() else None
