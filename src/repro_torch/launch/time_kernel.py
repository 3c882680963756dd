"""Time a hand-written kernel on the card: K1
(``kernels/scaled_update.py::fused_step_flat``) at a client count and a
flat size, K4 (``kernels/flash_attention.py``) at given shapes, or K7b
(``kernels/ssd_scan.py::ssd_intra_chunk_bwd``, the VJP of K7) at given
shapes beside its plain version and its bound. CUDA events around calls
made back to back (K4 and K7b add device time: the calls captured in one
CUDA graph, replayed); fp32 inputs from a seed. Prints the card's name and
power limit, then one JSON line a shape.

  PYTHONPATH=src python src/repro_torch/launch/time_kernel.py --kernel k1 \\
      --m 4 --n 495523712
  PYTHONPATH=src python src/repro_torch/launch/time_kernel.py --kernel k4 \\
      --shape 2,8192,14,2,64 --shape 4,2048,32,32,80 --shape 8,512,32,8,128
  PYTHONPATH=src python src/repro_torch/launch/time_kernel.py --kernel k7b \\
      --shape 2,2048,64,64,128,256

K1 runs with global D and the debias schedule (the savic round's step). A
K4 shape is B,S,H,Hk,D or B,S,H,Hk,D,window; a K7b shape B,S,H,P,N,Q with
one B/C group (B,S,H,P,N,Q,G for G groups, 1 or H): mamba2-1.3b's
training call is 2,2048,64,64,128,256. The script imports only the
timed kernel's module (and its ``build``; K7b its plain version too), so it
times whichever tree's package ``PYTHONPATH`` names: two trees in one call,
run in turns (A, B, B, A), compare on one card. K1 and K4 report times
only (their bounds are ``chip_smoke.py``'s); K7b adds its bound
(``ssd_scan.work_bwd`` at 67 TFLOP/s and 3.35 TB/s). CUDA only.
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


def time_k1(args, gen, dev):
    from repro_torch.kernels import scaled_update as su
    M, n = args.m, args.n
    p, m, g = (torch.randn((M, n), generator=gen, device=dev)
               for _ in range(3))
    d = torch.randn((n,), generator=gen, device=dev).abs_()
    t = torch.full((M,), 3, dtype=torch.int32, device=dev)
    kw = dict(gamma=0.05, beta1=0.9, alpha=1e-2, beta2=0.99, kind="adam",
              schedule="debias")
    ms = _ms(lambda: su.fused_step_flat(p, m, g, d, None, t, None, **kw),
             args.iters)
    print(json.dumps({"m": M, "n": n, "ms": ms,
                      "launches": su.fused_step_flat.launches}), flush=True)


def time_k4(args, gen, dev):
    from repro_torch.kernels import flash_attention as fa
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


def time_k7b(args, gen, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    for spec in args.shape:
        B, S, H, P, N, Q, *rest = (int(x) for x in spec.split(","))
        G = rest[0] if rest else 1
        nc = S // Q
        f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        ins = (f(B, S, H, P), torch.nn.functional.softplus(f(B, S, H)),
               -torch.exp(f(H)), f(B, S, G, N), f(B, S, G, N), Q,
               f(B, S, H, P), f(B, nc, H, N, P), f(B, nc, H))
        flops, nbytes = ssd.work_bwd(B, S, H, P, N, Q, G)
        print(json.dumps({
            "shape": [B, S, H, P, N, Q], "groups": G,
            "ms": _ms(lambda: ssd.ssd_intra_chunk_bwd(*ins), args.iters),
            "device_ms": _device_ms(lambda: ssd.ssd_intra_chunk_bwd(*ins)),
            "bound_ms": max(flops / 67e12, nbytes / 3.35e12) * 1e3,
            "gflop": flops / 1e9,
            "plain_ms": _ms(lambda: ref.ssd_intra_chunk_vjp_ref(*ins), 3),
            "launches": ssd.ssd_intra_chunk_bwd.launches}), flush=True)
        del ins
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k1", "k4", "k7b"), required=True)
    ap.add_argument("--m", type=int, default=4, help="k1: clients")
    ap.add_argument("--n", type=int, default=495_523_712,
                    help="k1: flat size a client")
    ap.add_argument("--shape", action="append", default=[],
                    help="k4: B,S,H,Hk,D[,window]; k7b: B,S,H,P,N,Q[,G]")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.kernel != "k1" and not args.shape:
        ap.error(f"--kernel {args.kernel} needs at least one --shape")
    if not torch.cuda.is_available():
        sys.exit("time_kernel: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    {"k1": time_k1, "k4": time_k4, "k7b": time_k7b}[args.kernel](args, gen,
                                                                 dev)


if __name__ == "__main__":
    main()
