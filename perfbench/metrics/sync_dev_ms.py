"""Device time a round of the sync: the device operations launched inside
the program's ``engine.sync`` (the average and its broadcast back),
``engine.precond`` (D's update at sync) and ``engine.server`` (an
adaptive server's step) spans, in the device-only span pass
(``spans.py``), in ms a round."""
from perfbench import spans

LAYER = "round engine: core/engine.build_round_step"
MOVES = "train_tok_s"
UNIT = "ms/round"


def read(ctx):
    p = spans.of(ctx)
    return p.under(["engine.sync", "engine.precond", "engine.server"]) \
        if p and p.read() else None
