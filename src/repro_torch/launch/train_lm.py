"""The LM-training runner on the port (counterpart of the ``train_lm`` bench
of ``benchmarks/run.py``: ``_run_train_lm`` and ``_sum_train_lm``).

Each of the engine's six methods trains qwen2-0.5b through
``repro_torch.launch.train.main`` at the bench's fixed point (M = 4
clients, H = 8 local steps, b = 4, S = 64, 10 rounds, seed 0) with the
bench's per-method step sizes (``TRAIN_LM_OVERRIDES``), on the fused client
loop (one fused-step kernel launch per local step). The model is the
bench's reduced qwen2-0.5b, or with ``--full`` the full-width one.

A row has the bench's shape: ``coords.method``; the metrics
``loss_first``, ``loss_last``, ``round_wall_s_mean`` (the steady rounds:
round 0 pays the first call's set-up), ``tokens_per_s``,
``tokens_per_s_per_device`` (the run uses one device) and
``sim_time_total``; ``info.loss_curve`` and ``info.loss_decreasing_trend``.
``summary(rows)`` gives ``_sum_train_lm``'s names.

The bench's ``projection:`` rows (``_train_lm_projection`` and
``_post_train_lm``): ``projection_rows()`` reads the ``train`` records of
``TRAIN_LM_ARCH`` that the port's dry run wrote (``launch/dryrun.py``, in
``results_torch/dryrun/``) and prices each with the H100 terms of
``launch/roofline.py``: a row ``projection:<shape>@<mesh>`` with
``n_devices``, ``tokens_per_round``, ``round_s_roofline`` (the largest
term), ``tok_s_dev_roofline``, ``tok_s_dev_compute_bound`` and
``model_flops_utilization``; ``summary`` names each
``tok_s_dev_proj_<shape>``. They are a cost model's outputs, not a run;
``main`` appends them after the methods' rows.

  PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \
      --methods savic,fedavg --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train_lm     # six, on cuda
  PYTHONPATH=src python -m repro_torch.launch.train_lm --full \
      --methods savic --rounds 3 --out /tmp/train_lm.json

The CLI prints one JSON row per line, then the summary; ``--out`` also
writes ``{"bench", "config", "rows", "summary"}`` to a file.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from repro_torch.launch import roofline, train

TRAIN_LM_OVERRIDES = {
    "savic": ["--gamma", "0.05"],
    "fedavg": ["--gamma", "6.0"],
    "fedadagrad": ["--gamma", "1.0", "--server-eta", "0.5"],
    "fedadam": ["--gamma", "1.0", "--server-eta", "0.5"],
    "fedyogi": ["--gamma", "1.0", "--server-eta", "0.5"],
    "local-adam": ["--gamma", "0.05", "--server-eta", "0.05"],
}
TRAIN_LM_ARCH = "qwen2-0.5b"
FIXED = dict(clients=4, h_local=8, batch=4, seq=64, rounds=10)
DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "..", "results_torch", "dryrun")


def argv_for(method, *, device, full=False, **fixed):
    """``train.main``'s arguments for one method (seed 0, the bench's)."""
    f = {**FIXED, **fixed}
    return (["--arch", TRAIN_LM_ARCH, "--method", method, "--rounds",
             str(f["rounds"]), "--h-local", str(f["h_local"]), "--clients",
             str(f["clients"]), "--batch", str(f["batch"]), "--seq",
             str(f["seq"]), "--seed", "0", "--device", str(device),
             "--use-fused-kernel"] + ([] if full else ["--reduced"])
            + TRAIN_LM_OVERRIDES[method])


def row_from_log(method, log, tokens_round):
    """The bench's row of one method's per-round records."""
    losses = [rec["loss"] for rec in log]
    walls = [rec["wall_s"] for rec in log]
    steady = walls[1:] or walls
    tps = tokens_round / float(np.mean(steady))
    half = len(losses) // 2
    return {
        "coords": {"method": method},
        "metrics": {
            "loss_first": round(losses[0], 4),
            "loss_last": round(losses[-1], 4),
            "round_wall_s_mean": round(float(np.mean(steady)), 4),
            "tokens_per_s": round(tps, 1),
            "tokens_per_s_per_device": round(tps, 1),
            "sim_time_total": log[-1]["sim_time"],
        },
        "info": {
            "loss_curve": [round(v, 4) for v in losses],
            "loss_decreasing_trend": bool(
                losses[-1] < losses[0]
                and np.mean(losses[half:]) < np.mean(losses[:half])),
        },
    }


def run_method(method, *, device, full=False, init_params=None,
               root_stream=None, **fixed):
    """One method's row. ``fixed`` overrides ``FIXED``; ``init_params`` and
    ``root_stream`` go to ``train.main`` (tests pass the reference's)."""
    f = {**FIXED, **fixed}
    log = train.main(argv_for(method, device=device, full=full, **f),
                     init_params=init_params,
                     root_stream=root_stream)
    return row_from_log(method, log, f["clients"] * f["h_local"]
                        * f["batch"] * f["seq"])


def projection(arch=TRAIN_LM_ARCH, ddir=DRYRUN_DIR):
    """Full-shape tokens/s a device from the dry run's records of ``arch``
    (``_train_lm_projection``): the H100 roofline bound over each ``ok``
    train record's per-rank counts."""
    proj = []
    for f in sorted(glob.glob(os.path.join(ddir, f"{arch}__*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("kind") != "train" or not rec.get("ok"):
            continue
        t = roofline.terms(rec)
        bound_s = max(t["compute_s"], t["memory_s"], t["collective_s"])
        tokens = rec["global_batch"] * rec["seq_len"] * rec.get("h_local", 8)
        proj.append({
            "shape": rec["shape"], "mesh": rec["mesh"], "mode": rec["mode"],
            "tag": rec.get("tag", ""), "n_devices": rec["n_devices"],
            "tokens_per_round": tokens,
            "round_s_roofline": round(bound_s, 6),
            "dominant_term": t["dominant"],
            "tok_s_dev_roofline": round(tokens / rec["n_devices"] / bound_s,
                                        1),
            "tok_s_dev_compute_bound": round(
                tokens / rec["n_devices"] / t["compute_s"], 1),
            "model_flops_utilization": round(t["roofline_frac"], 4),
        })
    return proj


def projection_rows(arch=TRAIN_LM_ARCH, ddir=DRYRUN_DIR):
    """The bench's ``projection:<shape>@<mesh>`` rows (``_post_train_lm``)."""
    return [{
        "coords": {"method": f"projection:{p['shape']}@{p['mesh']}"},
        "metrics": {k: p[k] for k in ("n_devices", "tokens_per_round",
                                      "round_s_roofline",
                                      "tok_s_dev_roofline",
                                      "tok_s_dev_compute_bound",
                                      "model_flops_utilization")},
        "info": {k: p[k] for k in ("shape", "mesh", "mode", "tag",
                                   "dominant_term")},
    } for p in projection(arch, ddir)]


def summary(rows):
    """``_sum_train_lm``'s (name, value) pairs: the loss drop and tokens/s
    per device of each method, and ``tok_s_dev_proj_<shape>`` of each
    projection row."""
    out = []
    for r in rows:
        m, method = r["metrics"], r["coords"]["method"]
        if method.startswith("projection:"):
            out.append((f"tok_s_dev_proj_{r['info']['shape']}",
                        m["tok_s_dev_roofline"]))
            continue
        name = method.replace("-", "_")
        if "loss_first" in m and "loss_last" in m:
            out.append((f"loss_drop_{name}",
                        round(m["loss_first"] - m["loss_last"], 4)))
        if "tokens_per_s_per_device" in m:
            out.append((f"tok_s_dev_{name}", m["tokens_per_s_per_device"]))
    return out


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--methods", default=",".join(TRAIN_LM_OVERRIDES),
                    help="comma-separated engine methods")
    ap.add_argument("--full", action="store_true",
                    help="full-width qwen2-0.5b instead of the reduced one")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rounds", type=int, default=FIXED["rounds"])
    ap.add_argument("--out", default="", help="write the rows here (JSON)")
    return ap


def main(argv=None):
    """Run the chosen methods; print and return (rows, summary)."""
    args = _parser().parse_args(argv)
    methods = [m for m in args.methods.split(",") if m]
    unknown = sorted(set(methods) - set(TRAIN_LM_OVERRIDES))
    if unknown:
        raise ValueError(f"unknown methods {unknown}; known: "
                         f"{list(TRAIN_LM_OVERRIDES)}")
    rows = []
    for method in methods:
        rows.append(run_method(method, device=args.device, full=args.full,
                               rounds=args.rounds))
        print(json.dumps(rows[-1]), flush=True)
    for row in projection_rows():
        rows.append(row)
        print(json.dumps(row), flush=True)
    summ = summary(rows)
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(json.dumps({"summary": dict(summ), "device": kind}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bench": "train_lm", "config": {
                "arch": TRAIN_LM_ARCH + ("" if args.full else "-reduced"),
                **FIXED, "rounds": args.rounds, "seed": 0,
                "device": kind}, "rows": rows,
                "summary": dict(summ)}, f, indent=1)
    return rows, summ


if __name__ == "__main__":
    main()
