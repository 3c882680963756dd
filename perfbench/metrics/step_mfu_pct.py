"""The whole round's share of the card's fp32 peak: the round's model
FLOPs (``counts``: one gradient a local step at 6 FLOPs a matmul parameter
a token plus attention or SSD, a Hutchinson probe as two more; recompute
not counted) over the untraced window's wall time a round (the host's
clock over all its rounds, as ``train_tok_s``), times 67 TFLOP/s. Left
out where the traced rounds ran nothing on a device."""
from perfbench import peaks

LAYER = "the whole round"
MOVES = "train_tok_s"
UNIT = "%"


def read(ctx):
    if not ctx.kernels:
        return None
    return 100.0 * ctx.cell["flops"] / (ctx.round_s * peaks.FP32_FLOPS)
