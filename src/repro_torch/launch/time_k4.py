"""Time kernel K4 (``kernels/flash_attention.py``) on the card at given
shapes: CUDA events around calls made back to back, and device time (the
calls captured in one CUDA graph, replayed), fp32, random inputs from a
seed. Prints the card's name and power limit, then one JSON line a shape.

  PYTHONPATH=src python src/repro_torch/launch/time_k4.py \\
      --shape 2,8192,14,2,64 --shape 4,2048,32,32,80 --shape 8,512,32,8,128

A shape is B,S,H,Hk,D or B,S,H,Hk,D,window. The script imports only
``repro_torch.kernels.flash_attention`` (and its ``build``), so it times
whichever tree's package ``PYTHONPATH`` names: two trees in one call, run
in turns (A, B, B, A), compare on one card. CUDA only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def _ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, calls=5, replays=4):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _ms(graph.replay, replays) / calls


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", required=True,
                    help="B,S,H,Hk,D[,window]")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_k4: no CUDA device")
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for spec in args.shape:
        B, S, H, Hk, D, *rest = (int(x) for x in spec.split(","))
        window = rest[0] if rest else 0
        q = torch.randn((B, S, H, D), generator=gen, device=dev)
        k = torch.randn((B, S, Hk, D), generator=gen, device=dev)
        v = torch.randn((B, S, Hk, D), generator=gen, device=dev)
        fn = (lambda: fa.flash_attention(q, k, v, window=window)) if window \
            else (lambda: fa.flash_attention(q, k, v))
        print(json.dumps({"shape": [B, S, H, Hk, D], "window": window,
                          "ms": _ms(fn, args.iters),
                          "device_ms": _device_ms(fn)}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
