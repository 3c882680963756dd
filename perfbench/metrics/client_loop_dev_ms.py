"""Device time a round of the local steps: the device operations launched
inside the program's ``engine.local_steps`` span (the ``client_run`` call
of ``core/engine.build_round_step``) and its subtree, backward included,
in the device-only span pass (``spans.py``), in ms a round."""
from perfbench import spans

LAYER = "round engine: core/engine.build_round_step"
MOVES = "train_tok_s"
UNIT = "ms/round"


def read(ctx):
    p = spans.of(ctx)
    return p.under(["engine.local_steps"]) if p and p.read() else None
