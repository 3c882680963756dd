"""The readings that a cell's limits are set from, on the chip at the
cell's own size (the benchmark's runs do not run this):

* the lower reading: the check's numbers of sound runs of the program,
  one a seed (``--seeds``), each in the benchmark's own set-up and check;
* the control: the reference in the program's place, computed in TF32
  (the precision below the configuration's fp32 with TF32 off), against
  the reference in fp32 (``--control-seeds``);
* faults planted in the reference put in the program's place, against
  the reference: half of each microbatch left out with the mean taken
  over the rest (``half_batch``), and one token altered in every round's
  batch where it is made (``token``). A state left unchanged reads 1 on
  ``change`` by the check's measure and needs no run.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9

prints one JSON line a seed: each reading's four numbers and ``correct``
as the check (``check.judge``) decides it against the cell's committed
limits, which the control and each fault have to fail. On a machine
without a card it runs on the CPU, where TF32 is emulated by rounding
every matmul operand to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import cells, check, harness, program  # noqa: E402


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away); the
    gradient passes through as if it were not rounded."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def tf32_einsum(eq, *ops):
    return torch.einsum(eq, *(tf32(o) for o in ops))


@contextlib.contextmanager
def tf32_on():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def half_batch_loss(loss_fn):
    def f(params, tok, lab, cfg, ein=torch.einsum):
        keep = max(tok.shape[0] // 2, 1)
        return loss_fn(params, tok[:keep], lab[:keep], cfg, ein)
    return f


def alter_token(tok, lab, r):
    tok = tok.copy()
    S = tok.shape[-1]
    tok[0, 0, 0, S // 2] = (tok[0, 0, 0, S // 2] + 1) % (tok.max() + 1)
    return tok, lab


def judged(cell, snap: dict, ref: dict) -> dict:
    """The check's numbers of ``snap`` against ``ref``, and ``correct`` as
    the cell's limits decide it."""
    read = check.readings(snap, ref)
    return {**read, "correct": check.judge(read, cell.workload["limits"])[0]}


def variants(cell, seed: int, device: str, ref: dict) -> dict:
    """The control's and the faults' readings against ``ref``, the fp32
    reference of this seed."""
    out = {}
    if device == "cuda":
        with tf32_on():
            ctl = harness.reference_rounds(cell, seed, device)
    else:
        ctl = harness.reference_rounds(cell, seed, device, ein=tf32_einsum)
    out["control_tf32"] = judged(cell, ctl, ref)
    half = harness.reference_rounds(
        cell, seed, device, loss_fn=half_batch_loss(cell.reference().loss))
    out["half_batch"] = judged(cell, half, ref)
    tok = harness.reference_rounds(cell, seed, device, batch_hook=alter_token)
    out["token"] = judged(cell, tok, ref)
    return out


def sound(cell, seed: int, device: str):
    """(the program's readings, the fp32 reference) of one seed."""
    prog = program.Program(cell, seed, device)
    snap = prog.first_rounds(check.FIRST_ROUNDS)
    prog.free()
    del prog
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = harness.reference_rounds(cell, seed, device)
    return judged(cell, snap, ref), ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(harness.ROOT, "src"))
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = cells.load(harness.ROOT, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = cell.config["tf32"]
    torch.backends.cudnn.allow_tf32 = cell.config["tf32"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in dict.fromkeys(seeds + ctl):
        t = time.perf_counter()
        rec = {"workload": cell.name, "seed": seed}
        if seed in seeds:
            rec["program"], ref = sound(cell, seed, device)
        else:
            ref = harness.reference_rounds(cell, seed, device)
        if seed in ctl:
            rec.update(variants(cell, seed, device, ref))
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
    if device == "cuda":
        print(json.dumps({"card": harness.card_line()}), flush=True)


if __name__ == "__main__":
    main()
