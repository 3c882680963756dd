"""Device time a round of the matrix multiplications (cuBLAS and CUTLASS
kernels, by name) of the model's forward and backward passes, in ms a
round."""
import re

LAYER = "model forward and backward: models/*"
MOVES = "train_tok_s"
UNIT = "ms/round"
GEMM = re.compile(r"gemm|gemv|cutlass|xmma|splitKreduce", re.IGNORECASE)


def read(ctx):
    ks = [s for name, s in ctx.kernels if GEMM.search(name)]
    return 1e3 * sum(ks) / ctx.rounds if ks else None
