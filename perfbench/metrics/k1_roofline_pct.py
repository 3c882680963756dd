"""Kernel K1's share of its bytes roofline: the local step's bytes
(``counts/savic.k1_bytes``: each input of the update read once and each
output written once, from (M, n) and the method's state) over 3.35 TB/s,
against K1's device time a launch."""
from perfbench import peaks

LAYER = "kernel K1: kernels/scaled_update.py, csrc/fused_step.cu"
MOVES = "train_tok_s"
UNIT = "%"
NAMES = ("fused_step_vec4", "fused_step_scalar")


def read(ctx):
    ks = [s for name, s in ctx.kernels if any(n in name for n in NAMES)]
    if not ks:
        return None
    return 100.0 * ctx.cell["k1_bytes"] / peaks.HBM_BYTES_PER_S \
        / (sum(ks) / len(ks))
