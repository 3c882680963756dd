"""Device time a round of the expert layers' routing: the device
operations launched inside the program's ``model.moe.route`` spans (the
router's matmul, the sigmoid, the sort of the picks, the held choices'
sort, the gather of their rows and the weighted scatter back), their
remat ``.recompute`` and their ``.bwd``, apart from the experts' matmuls,
in the device-only span pass (``spans.py``), in ms a round. A program
without the span gives nothing."""
from perfbench import spans

LAYER = "model forward and backward: models/*"
MOVES = "train_tok_s"
UNIT = "ms/round"
NAMES = ("model.moe.route", "model.moe.route.recompute",
         "model.moe.route.bwd")


def read(ctx):
    p = spans.of(ctx)
    return (p.under(NAMES) or None) if p and p.read() else None
