"""The per-leaf numbers that the benchmark compares, worked out the same
way from the program's state and from the reference's: norms accumulated
in fp64 (a norm in fp32 over 10^8 elements is itself off by ~1e-7, about
what the comparison has to see), in chunks so that no fp64 copy of a
whole leaf is made.

* ``mom``: the momentum after the first round, as the sync left it (the
  clients' first gradients as the optimizer got them);
* ``dstat``: the preconditioner's statistic after the first round, from
  its D: under Adam with global scaling √D = |ḡ|, the mean of the clients'
  last gradients; under OASIS with local scaling (D − c) / (1 − β), the
  Hutchinson diagonals the H local steps added, over every client's row
  (c: D's start, 1, decayed H times in fp32);
* ``change``: the params after the third round minus the weights.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 24


def _chunks(x: torch.Tensor):
    """Contiguous 1-D pieces of ``x`` (row by row where ``x`` is a strided
    view, as a flat buffer's (M, ...) leaves are), with no copy."""
    if x.is_contiguous():
        flat = x.view(-1)
        for i in range(0, flat.numel(), CHUNK):
            yield flat[i:i + CHUNK]
    else:
        for row in x.unbind(0):
            yield from _chunks(row)


def sumsq64(x: torch.Tensor, offset: float = 0.0) -> float:
    """Σ (x − offset)², accumulated in fp64."""
    s = torch.zeros((), dtype=torch.float64, device=x.device)
    for piece in _chunks(x):
        s += (piece.double() - offset).square().sum()
    return float(s)


def sum64(x: torch.Tensor) -> float:
    s = torch.zeros((), dtype=torch.float64, device=x.device)
    for piece in _chunks(x):
        s += piece.double().sum()
    return float(s)


def decayed_one(beta2: float, steps: int, device) -> torch.Tensor:
    """1 after ``steps`` fp32 updates d ← β·d + (1 − β)·0."""
    b = torch.tensor(beta2, dtype=torch.float32, device=device)
    d = torch.ones((), device=device)
    for _ in range(steps):
        d = b * d + (1.0 - b) * 0.0
    return d


def dstat_norm_rows(rows, job) -> float:
    """The ``dstat`` norm of one leaf of D, given as a list of tensors: the
    leaf itself (global D), or each client's row of it (local D)."""
    if job["preconditioner"] == "adam" and job["scaling"] == "global":
        return sum(sum64(d) for d in rows) ** 0.5
    if job["preconditioner"] == "oasis" and job["scaling"] == "local":
        c = float(decayed_one(job["beta2"], job["h_local"], rows[0].device))
        return sum(sumsq64(d, c) for d in rows) ** 0.5 / (1.0 - job["beta2"])
    raise ValueError(f"no dstat for {job['preconditioner']} with "
                     f"{job['scaling']} scaling")
