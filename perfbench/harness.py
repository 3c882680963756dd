"""One run of one cell: set-up, the measured window, the check.

1. Set-up (``setup_s``, from the process's start): import, the program's
   ``train.setup`` with the benchmark's weights made on the device from
   the seed, and the first rounds (``check.FIRST_ROUNDS``, 3) through the
   window's own call and feed. They build K1 (a checkout's first run: its
   build time is also kept apart, as ``build_s`` in ``clock_s``), warm
   every shape the window uses, and are what the check compares.
2. The window: whole rounds back to back from round 3 until ``--seconds``
   have passed, ended by a synchronise when the last round started inside
   it completes. ``train_tok_s`` is the tokens of those rounds (M·H·b·S
   each) over the window's whole wall time, batch making included;
   ``train_peak_gib`` the allocator's peak over set-up and window. With
   ``--trace 1`` the same window runs, and then ``trace.TRACE_ROUNDS``
   rounds under the profiler (``trace.py``); the result carries the
   per-layer metrics (``metrics/<name>.py``), read from the traced rounds
   and the window's time a round, and the breakdown.
3. The check, once the peak is read and the program's state freed: the
   plain reference (``reference/``) runs the first rounds again from the
   seed and ``check`` compares them; the numbers and their limits print
   last on standard error and last in the result's line.

The result is the last line of standard output. A run exits with another
code than 0 and prints no result without a card, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded when the
window has closed.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

from perfbench import cells, check, program
from perfbench.reference import weights

ROOT = os.path.dirname(cells.HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else out.stderr.strip()


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def cell_counts(cell, n: int) -> dict:
    job = cell.job
    from perfbench.counts import savic
    fpt = cell.family().grad_flops_per_token(cell.config, job["seq"])
    return {"tokens": job["clients"] * job["h_local"] * job["batch"]
            * job["seq"],
            "flops": savic.round_flops(job, fpt),
            "k1_bytes": savic.k1_bytes(job, n)}


def window(prog, r0: int, seconds: float, device):
    """Rounds from ``r0`` until ``seconds`` have passed; (rounds, wall
    seconds, their losses as device tensors)."""
    losses, r, starts = [], r0, []
    t0 = time.perf_counter()
    while True:
        starts.append(time.perf_counter() - t0)
        batch = prog.batch(r)
        losses.append(prog.step(batch, r))
        del batch
        r += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return r - r0, time.perf_counter() - t0, losses, starts


def reference_rounds(cell, seed: int, device, loss_fn=None, **kw):
    """The reference's first rounds of ``cell`` (``reference/savic.py``;
    ``loss_fn`` in place of the model's loss, ``kw`` its options)."""
    from perfbench.reference import savic
    return savic.rounds(cell.config, cell.job,
                        loss_fn or cell.reference().loss, cell.spec(), seed,
                        check.FIRST_ROUNDS, device, **kw)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float):
    """(result dict, the check's lines) of one run."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = cell.config["tf32"]
    torch.backends.cudnn.allow_tf32 = cell.config["tf32"]
    # one process with few threads: the round's host work is one thread's
    torch.set_num_threads(1)
    seed = seed % (1 << 63)
    n_first = check.FIRST_ROUNDS
    clock = {"import": time.perf_counter() - t_start}
    from repro_torch.launch import train  # noqa: F401  (timed apart)
    clock["program_import"] = time.perf_counter() - t_start
    prog = program.Program(cell, seed, device)
    clock["program_setup"] = time.perf_counter() - t_start
    snap = prog.first_rounds(n_first)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    clock["first_rounds"] = setup_s
    from repro_torch.kernels import build
    clock["build_s"] = sum(b["seconds"] for b in build.BUILD_LOG.values())
    counts = cell_counts(cell, sum(v[0].numel() for _, v in
                                   weights.paths(prog.state["mom"])))
    rounds, wall, losses, starts = window(prog, n_first, seconds, device)
    clock["round_starts"] = starts
    metrics, extra, breakdown = {}, {}, None
    if trace:
        from perfbench import trace as tr
        ctx = tr.traced_rounds(prog, n_first + rounds)
        ctx.cell, ctx.round_s = counts, wall / rounds
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
        breakdown = ctx.breakdown
        rounds += ctx.rounds
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if not trace:
        values = {"setup_s": setup_s,
                  "train_tok_s": rounds * counts["tokens"] / wall,
                  "train_peak_gib": peak / 2 ** 30}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    failed = sum(not math.isfinite(x) for x in snap["losses"]) + (
        int((~torch.isfinite(torch.stack(losses))).sum()))
    del losses
    prog.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    clock["window"] = time.perf_counter() - t_start
    ref = reference_rounds(cell, seed, device)
    clock["reference"] = time.perf_counter() - t_start
    ok, checks, at = check.compare(snap, ref, cell.workload["limits"])
    result = {"correct": bool(ok and failed == 0),
              "attempted": n_first + rounds, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu",
                         "kind": torch.cuda.get_device_name(0)
                         if device == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": peak, **extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = card_line() if device == "cuda" else "cpu"
    result["clock_s"] = clock          # seconds since the process started
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r}; {at[k]})"
             for k, c in checks.items()]
    return result, lines


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    cell = cells.load(ROOT, args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 3
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
