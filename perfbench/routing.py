"""How the program and the reference route the same tokens, for a cell
whose model has expert layers (``nemotron_h``), on the chip at the cell's
own size (the benchmark's runs do not run this):

* each expert layer's picks on round 0's first microbatch of the first
  client, from the benchmark's weights of a seed, in the program (its
  training forward: grad on, remat, the SSD on K7) and in the reference;
* ``flipped``: the tokens whose set of K picks differs between the two,
  a layer; ``held_moved``: those of them whose picks on the held experts
  differ (the only flips that change what this chip computes);
* ``held``: the choices that land on a held expert in the program, a
  layer, beside the N·K·n_held/E an even routing would give.

    python3 perfbench/routing.py --workload <cell> --seeds 1,2,...

prints one JSON line a seed, with the card it ran on; without a CUDA
device it exits non-zero (the CPU's SSD and attention are not the card's,
so its flips would not be the cell's).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import cells, harness, program  # noqa: E402
from perfbench.reference import data, weights  # noqa: E402


def _microbatch(cell, seed: int, device):
    job = cell.job
    table = data.chains(cell.config["vocab_size"], seed)
    tok, lab = data.round_tokens(table, seed, 0, (
        job["clients"], job["h_local"], job["batch"], job["seq"]))
    to = lambda a: torch.from_numpy(a[0, 0]).to(device=device,
                                                dtype=torch.long)
    return to(tok), to(lab)


def program_picks(cell, seed: int, device) -> list:
    from repro_torch import configs
    from repro_torch.models import ModelCallConfig, build, moe
    cfg = configs.get_config(program.arch_id(cell.config))
    model = build(cfg, ModelCallConfig(dtype=torch.float32))
    params = weights.make(cell.spec(), seed, device)
    for _, v in weights.paths(params):
        v.requires_grad_(True)
    tok, lab = _microbatch(cell, seed, device)
    out, real = [], moe.route_sigmoid

    def spy(p, c, x, picks=None):
        got = real(p, c, x, picks)
        if picks is None:
            out.append(got[0].detach())
        return got
    moe.route_sigmoid = spy
    try:
        with torch.enable_grad():
            model.loss(params, {"tokens": tok, "labels": lab})
    finally:
        moe.route_sigmoid = real
    return out


def reference_picks(cell, seed: int, device) -> list:
    ref = cell.reference()
    params = weights.make(cell.spec(), seed, device)
    tok, lab = _microbatch(cell, seed, device)
    out, real = [], ref.route

    def spy(t, mp, cfg, ein):
        got = real(t, mp, cfg, ein)
        out.append(got[0])
        return got
    ref.route = spy
    try:
        with torch.no_grad():
            ref.loss(params, tok, lab, cell.config)
    finally:
        ref.route = real
    return out


def compare(cell, prog: list, ref: list) -> dict:
    c = cell.config
    first, n = c.get("first_expert", 0), c["n_experts"]
    held = lambda p: torch.where((p >= first) & (p < first + n), p, -1) \
        .sort(-1).values
    flipped, moved, counts = [], [], []
    for a, b in zip(prog, ref):
        flipped.append(int((a.sort(-1).values != b.sort(-1).values)
                           .any(-1).sum()))
        moved.append(int((held(a) != held(b)).any(-1).sum()))
        counts.append(int(((a >= first) & (a < first + n)).sum()))
    N, K = prog[0].shape
    return {"tokens": N, "flipped": flipped, "held_moved": moved,
            "held": counts, "held_even": N * K * n / c["n_routed_experts"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(harness.ROOT, "src"))
    if not torch.cuda.is_available():
        raise SystemExit("routing.py reads the card's routing: no CUDA "
                         "device here")
    device, card = "cuda", harness.card_line()
    cell = cells.load(harness.ROOT, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = cell.config["tf32"]
    torch.backends.cudnn.allow_tf32 = cell.config["tf32"]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        rec = {"workload": cell.name, "seed": seed, "device": card,
               **compare(cell, program_picks(cell, seed, device),
                         reference_picks(cell, seed, device))}
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
