"""The SAVIC round's model FLOPs and the bytes of its local step (K1).

A round is M·H local steps of b·S tokens. Each takes one gradient; a
Hutchinson probe (OASIS, AdaHessian) counts as two more (forward over
reverse), once a local step under local scaling, once a round on one
microbatch under global scaling.

K1, one launch a local step over the (M, n) flat client state, reads each
input once and writes each output once: params, momentum and the last
gradient (M·n each) in, params and momentum out; a global D (n) in, or a
local D (M·n) in and out, with a per-client step count (M int32) in and
out and, for a Hutchinson stat, the stat (M·n) in. 4 bytes an element.
"""

HUTCHINSON = ("oasis", "adahessian")


def round_flops(job, grad_flops_per_token: float) -> float:
    M, H, b, S = job["clients"], job["h_local"], job["batch"], job["seq"]
    probe = job["preconditioner"] in HUTCHINSON
    grads = M * H * (1 + (2 if probe and job["scaling"] == "local" else 0))
    if probe and job["scaling"] == "global":
        grads += 2
    return grads * b * S * grad_flops_per_token


def k1_bytes(job, n: int) -> float:
    M, kind = job["clients"], job["preconditioner"]
    elems = 5 * M * n                     # P, m, g in; P, m out
    if kind != "identity":
        if job["scaling"] == "local":
            elems += 2 * M * n + 2 * M    # D in and out, t in and out
            if kind in HUTCHINSON:
                elems += M * n            # the stat
        else:
            elems += n                    # the shared D
    return 4.0 * elems
