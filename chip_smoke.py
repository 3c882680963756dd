"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, started together), holds each against its plain
PyTorch version on the card (K2, the per-leaf scaled step, bitwise over
ragged n, misaligned views and two launches past 2^31 elements), drives the
port's paths through ``repro_torch.launch.train.main`` at the full width of
qwen2-0.5b (the SAVIC round; local-adam; SAVIC with int8-stochastic
compression and error feedback; SAVIC with OASIS and half the clients
sampled; then the round's knobs at H = 4: per-client H_m from lognormal
step times with a depth-2 staleness FIFO beside the uniform round, the
adaptive controller with topk and error feedback, its knobs replayed by
``tests/_reference_controller.py``, and local-adam with the consistency
objective on half-labeled sequences and a client-resident final norm),
runs the pre-refactor round's per-leaf step (the momentum pass,
then ``ops.scaled_update_tree``: K2 once a leaf) on the Fig. 1 MLP, on the
reference kernels_fused bench's leaves and on full-width qwen2-0.5b, held
against the tree step and timed beside K1, holds the fused client loop
against the tree loop (also under H_m with the FIFO, and under the
controller), runs the paper's experiments through
``repro_torch.launch.paper`` (Fig. 1 at main_frac 0.5 for its five methods
on the tree and fused loops, Theorem 1's transient, §5.2's six points),
then drives the serving path through ``repro_torch.launch.serve`` at full
width (prefill-cache reuse with 63 decode steps on K5 and K6; continuous
batching over a ring of 8 slots; an 8192-token prompt at batch 2 prefilled
on K4, then 31 decode steps; then the SSM family: full-width mamba2-1.3b
prefilled at batch 4 from a 2048-token prompt through K7 into its
recurrent state, 63 decode steps on K6, and continuous batching of 16
requests on 8 slots), holds K6 at heads wider than 2048 (d = 2560, 8192),
holds the kernel paths against the plain ones teacher-forced (the K4
prefill against the chunked ``models/flash.py`` one, the K7 prefill against
``models.ssm.ssd_chunked``), and checks what comes out.
Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
before printing any result.

The second-to-last lines are one JSON object listing the kernels (launches
on the main path, error against the plain version (K4's over its fp32
cases, K7's over all its cases), measured and least possible times; K2's
times are one per-leaf step over full-width qwen2-0.5b's 14 leaves at M =
4) and the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PrecondConfig, engine  # noqa: E402
from repro_torch.core import preconditioner as PC  # noqa: E402
from repro_torch.data import (LMRoundLoader, TokenStream,  # noqa: E402
                              federated, main_class_partition)
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_step as ds  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quantize_update as qu  # noqa: E402
from repro_torch.kernels import scaled_update as su  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import paper  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (ModelCallConfig, sample_batch,  # noqa: E402
                                sample_ids)
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.models.flash import flash_attention_bshd  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.utils import rng  # noqa: E402
from repro_torch.utils.flatten import FlatLayout  # noqa: E402
from repro_torch.utils.tree import tree_map, tree_paths, tree_size  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# the controller's numpy oracle (numpy only), beside the tests
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
import _reference_controller as ref_ctrl  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12            # fp32 outside the tensor cores
DEV = torch.device("cuda", 0)
H_LOCAL = 2
K1_N = 1 << 20                     # row length of the kernel-vs-plain cases
BIG = (3, 716_000_001)             # M, n of the launch with M·n > 2^31
# K3 launches with M·n > 2^31: odd n (scalar path) and n % 4 == 0 (float4)
K3_BIG = ((3, 716_000_001), (4, 537_000_000))
EMBED = (4, 137_625_600)           # the embed.table leaf at M=4, full width
N_LEAVES = 14                      # parameter leaves of qwen2-0.5b
INT8_EF = ["--compression", "int8-stochastic", "--error-feedback"]
OASIS_HALF = ["--preconditioner", "oasis", "--participation", "0.5"]
# the round's knobs at full width, H = 4: lognormal step times at seed 0
# give H_m = (3, 4, 2, 3) (stragglers freeze mid-round) and a spread of 1.59
# (the controller's b_eff = 2, and at H_t = 1 three clients sit out)
H_KNOBS = 4
HET_ASYNC = ["--h-local", str(H_KNOBS), "--het-model", "lognormal",
             "--het-seed", "0", "--async-buffer", "2", "--staleness-weight",
             "polynomial"]
CONTROLLER = ["--h-local", str(H_KNOBS), "--controller", "--async-buffer",
              "2", "--het-model", "lognormal", "--het-seed", "0",
              "--compression", "topk", "--compression-k", "0.1",
              "--error-feedback"]
SEMI_PERSONAL = ["--objective", "consistency", "--labeled-frac", "0.5",
                 "--personalize", "final_norm"]
# serving: batch 8, prompt 512, 64 tokens (63 decode steps) at full width
SERVE = dict(batch=8, prompt_len=512, gen_len=64)
K5_MAIN = (8, 576, 2, 7, 64)       # B, C, Hk, rep, D of the decode steps
K5_PER_CALL = 2                    # K5 launches a call: partials, then merge
K5_MAIN_SPLITS = (32, 64, 96)      # split lengths timed beside the plan's
V_PAD, V_REAL, D_MODEL = 153_600, 151_936, 896
TRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
             arrival_rate=0.5, seed=0)
# long-prompt prefill: batch 2, prompt 8192, 32 tokens (31 decode steps)
LONG = dict(batch=2, prompt_len=8192, gen_len=32)
K4_MAIN = (2, 8192, 14, 2, 64)     # B, S, H, Hk, D of the prefill's K4
K5_LONG = (2, 8224, 2, 7, 64)      # B, C, Hk, rep, D of its decode steps
K5_LONG_SPLITS = (64, 96, 128, 160)
# K4 against its plain version: (B, S, H, Hk, D, window, softcap, dtype)
K4_CASES = [(*K4_MAIN, 0, 0.0, torch.float32),
            (2, 2048, 8, 1, 64, 0, 0.0, torch.float32),        # MQA
            (2, 2048, 14, 2, 32, 0, 0.0, torch.float32),
            (2, 2048, 14, 2, 128, 0, 0.0, torch.float32),
            (2, 2048, 14, 2, 64, 16, 0.0, torch.float32),
            (2, 2048, 14, 2, 64, 100, 0.0, torch.float32),
            (2, 2048, 14, 2, 64, 0, 30.0, torch.float32),
            (*K4_MAIN, 0, 0.0, torch.bfloat16),
            (2, 1, 14, 2, 64, 0, 0.0, torch.float32),
            (2, 1000, 14, 2, 64, 0, 0.0, torch.float32),
            # S not a multiple of the 64-row tile, with D 32 / 128, a
            # window and softcap, and bf16
            (2, 8191, 14, 2, 64, 0, 0.0, torch.float32),
            (1, 2049, 14, 2, 128, 300, 30.0, torch.float32),
            (1, 1025, 14, 2, 32, 0, 0.0, torch.float32),
            (1, 4097, 14, 2, 64, 0, 0.0, torch.bfloat16)]
# mamba2-1.3b serving: batch 4, prompt 2048, 64 tokens (63 decode steps)
MAMBA = dict(batch=4, prompt_len=2048, gen_len=64)
K7_MAIN = (4, 2048, 64, 64, 128, 256)   # B, S, H, P, N, Q of the prefill's K7
N_MAMBA_LAYERS = 48
MTRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
              arrival_rate=0.5, seed=0)
K7_ONE = (1, 256, 64, 64, 128, 256)     # the continuous-batching prefill's
# K7 against its plain version: (B, S, H, P, N, Q, A, shared B/C): the
# prefill's shape with one B/C group over the heads (head stride 0, as the
# model passes them) and per head; Q 64/128 x N 16/64 x P 32/128; one chunk
# (the continuous-batching prefill); A = -16 on every head (largest |cum|);
# B with head stride 0 beside a per-head C ("B": the per-head G path); one
# chunk with A = -16
K7_CASES = [(*K7_MAIN, None, True), (*K7_MAIN, None, False),
            *[(2, 512, 8, P, N, Q, None, False) for Q in (64, 128)
              for N in (16, 64) for P in (32, 128)],
            (*K7_ONE, None, True),
            (*K7_MAIN, -16.0, True),
            (2, 512, 8, 64, 64, 128, None, "B"),
            (*K7_ONE, -16.0, True)]
U = 2.0 ** -24
# K2 against its plain version: n of every residue mod 4 around the float4
# width and at 2^20; one launch with n > 2^31 on aligned tensors (float4
# with a masked tail) and on views one float in (the scalar path)
K2_NS = (1, 3, 4, 5, 127, 128, 129, 1 << 20, (1 << 20) + 3)
K2_BIG = (1 << 31) + 3
# the per-leaf step's trees: the Fig. 1 MLP (192 -> 128 -> 10) at M = 10, the
# reference kernels_fused bench's leaves at M = 8; full-width qwen2-0.5b at
# M = 4 comes from the model
MLP_TREE = ({"w1": (192, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)},
            10)
BENCH_TREE = ({"w1": (256, 128), "b1": (128,), "w2": (128, 10),
               "b2": (10,)}, 8)
K2_STEP = dict(gamma=0.002, beta1=0.9, alpha=1e-2)   # Fig. 1's constants
# K6 at heads wider than 2048 (y staged in slices over d): (V, v_real, d,
# table scale, logit scale); V padded to a multiple of 2048
WIDE_HEADS = {"zamba2-2.7b": (32_768, 32_000, 2560, 2560 ** -0.5, 1.0),
              "gemma3-4b": (262_144, 262_144, 2560, 2560 ** -0.5, 1.0),
              "qwen3-4b": (153_600, 151_936, 2560, 2560 ** -0.5, 1.0),
              "deepseek-67b": (102_400, 102_400, 8192, 8192 ** -0.5, 1.0)}
# the paper's experiments on the card: fig1 at one main fraction, all five
# methods, tree and fused (K1) loops; fused against tree per round within
# 1e-5 of the loss (both run the same fp32 operations; K1 is bitwise its
# plain version) and 2 of the 1000 held-out examples
FIG1_FRAC = 0.5
FIG1_TOL = 1e-5


def main_argv(method, rounds, extra=()):
    return ["--arch", "qwen2-0.5b", "--method", method, "--use-fused-kernel",
            "--rounds", str(rounds), "--h-local", str(H_LOCAL), "--clients",
            "4", "--batch", "8", "--seq", "128", "--device", "cuda",
            *extra]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line(query="name,power.limit"):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def max_diff(a, b, chunk=1 << 26):
    """(max abs, max fp32 ulp) difference of two same-shape fp32 tensors,
    over flat chunks so that the int64 temporaries stay small at full width.
    Ulps come from a monotone int mapping of the bit patterns."""
    def key(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    a, b = a.reshape(-1), b.reshape(-1)
    err, ulps = 0.0, 0
    for lo in range(0, a.numel(), chunk):
        x, y = a[lo:lo + chunk], b[lo:lo + chunk]
        err = max(err, float((x - y).abs().max()))
        ulps = max(ulps, int((key(x) - key(y)).abs().max()))
    return err, ulps


def cuda_ms(fn, iters):
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


def graph_ms(fn, calls=50, replays=20):
    """Device time of one ``fn()`` call: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events. It leaves
    out the host's time to issue each call (Python, allocation, launch),
    which back-to-back ``cuda_ms`` timing counts where a call's device work
    is shorter than its host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, replays) / calls
    del graph
    return ms


def k3_bytes(M, n):
    """Bytes K3 must move: read x, u and the row scales, write q and dec."""
    return M * n * (4 + 4 + 1 + 4) + 4 * M


def k1_bytes(M, n, d, h, update_d):
    """Bytes K1 must move: read p, m, g (+ d, + h), write p', m' (+ d')."""
    n_d = 0 if d is None else (M * n if d == "local" else n)
    reads = 3 * M * n + n_d + (M * n if h else 0)
    writes = 2 * M * n + (M * n if update_d else 0)
    return 4 * (reads + writes)


# --------------------------------------------------------------------------- #
# K1 inputs and the kernel-vs-plain comparison
# --------------------------------------------------------------------------- #

# (kind, schedule, clip, d, update_d, wd, h, s)
K1_CASES = [
    ("identity", "const", "max", None, False, 0.0, False, False),
    ("identity", "const", "max", None, False, 0.01, False, True),
    ("adam", "debias", "max", "global", False, 0.0, False, False),
    ("adam", "debias", "max", "local", True, 0.0, False, False),
    ("adam", "debias", "add", "local", True, 0.01, False, True),
    ("adam", "const", "max", "local", True, 0.0, True, False),
    ("adam", "debias", "add", "global", False, 0.01, False, True),
    ("rmsprop", "const", "max", "local", True, 0.0, False, True),
    ("rmsprop", "const", "add", "global", False, 0.0, False, False),
    ("rmsprop", "debias", "max", "local", True, 0.01, True, False),
    ("adagrad", "const", "max", "local", True, 0.0, False, False),
    ("adagrad", "const", "add", "local", True, 0.01, True, True),
    ("adagrad", "const", "max", "global", False, 0.0, False, True),
    ("oasis", "const", "max", "local", True, 0.0, True, False),
]


def k1_inputs(case, M, n, gen):
    kind, schedule, clip, dmode, update_d, wd, has_h, has_s = case
    f = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    args = {"p": f(M, n), "m": f(M, n), "g": f(M, n), "d": None, "h": None,
            "t": torch.randint(0, 50, (M,), generator=gen, device=DEV,
                               dtype=torch.int32), "s": None}
    if dmode == "local":
        args["d"] = f(M, n) if kind == "oasis" else f(M, n).abs_()
    elif dmode == "global":
        args["d"] = f(n).abs_()
    if has_h:
        args["h"] = f(M, n) if kind == "oasis" else f(M, n).square_()
    if has_s:
        args["s"] = torch.rand((M,), generator=gen, device=DEV) * 0.9 + 0.1
    kw = dict(gamma=0.05, beta1=0.9, weight_decay=wd, alpha=1e-2,
              beta2=0.99, kind=kind, clip=clip, schedule=schedule,
              update_d=update_d)
    return args, kw


ORDER = ("p", "m", "g", "d", "h", "t", "s")


def compare_case(case, M, n, gen):
    """Plain version on copies, kernel in place; returns (max abs, max ulp)
    over the outputs."""
    args, kw = k1_inputs(case, M, n, gen)
    want = ref.fused_step_ref(*(args[k] for k in ORDER), **kw)
    got = su.fused_step_flat(*(args[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for w, g in zip(want, got):
        if w is not None:
            e, u = max_diff(w, g)
            err, ulps = max(err, e), max(ulps, u)
    return err, ulps


def big_case(gen):
    """One launch with M·n > 2^31 (64-bit offsets): local Adam with update,
    debias, clip scale and weight decay, n odd (scalar path). Compared on
    slices at the head of the first row and the tail of the last."""
    (M, n), K = BIG, 1 << 16
    case = ("adam", "debias", "add", "local", True, 0.01, False, True)
    args, kw = k1_inputs(case, M, n, gen)
    check(M * n > 2 ** 31, "big case is not above 2^31 elements")
    sl = {"head": (slice(0, 1), slice(0, K)),
          "tail": (slice(M - 1, M), slice(n - K, n))}
    saved = {name: {k: args[k][rows, cols].clone() for k in ("p", "m", "g",
                                                              "d")}
             for name, (rows, cols) in sl.items()}
    su.fused_step_flat(*(args[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for name, (rows, cols) in sl.items():
        x = saved[name]
        want = ref.fused_step_ref(x["p"], x["m"], x["g"], x["d"], None,
                                  args["t"][rows], args["s"][rows], **kw)
        for w, k in zip(want, ("p", "m", "d")):
            e, u = max_diff(w, args[k][rows, cols])
            err, ulps = max(err, e), max(ulps, u)
    del args, saved
    torch.cuda.empty_cache()
    return M, n, err, ulps


def k1_main_shape(case, M, n, gen, plain_timing, iters=10):
    """K1 at the main path's shape, checked against its plain version and
    then timed. Returns (max abs, max ulp, ms, plain ms or None, bytes).

    The plain version runs row by row on (1, n) views of fresh inputs: every
    op is elementwise, so each row's values are those of one (M, n) call,
    and its temporaries stay one row wide. The kernel then runs once at
    (M, n), in place, and each of its rows is held against the plain one.
    The plain version is timed at (M, n) only where its temporaries (~4 more
    (M, n) buffers) fit beside the inputs (``plain_timing``)."""
    torch.cuda.empty_cache()
    args, kw = k1_inputs(case, M, n, gen)
    local_d = args["d"] is not None and args["d"].dim() == 2
    want = []
    for i in range(M):
        row = {k: (None if args[k] is None
                   else args[k] if k == "d" and not local_d
                   else args[k][i:i + 1]) for k in ORDER}
        want.append(ref.fused_step_ref(*(row[k] for k in ORDER), **kw))
    su.fused_step_flat(*(args[k] for k in ORDER), **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for i, outs in enumerate(want):
        for w, k in zip(outs, ("p", "m", "d")):
            if w is not None:
                e, u = max_diff(w, args[k][i:i + 1])
                err, ulps = max(err, e), max(ulps, u)
    del want
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: su.fused_step_flat(*(args[k] for k in ORDER), **kw),
                 iters)
    plain_ms = cuda_ms(lambda: ref.fused_step_ref(*(args[k] for k in ORDER),
                                                  **kw), 3) \
        if plain_timing else None
    nbytes = k1_bytes(M, n, case[3], case[6], case[4])
    del args
    torch.cuda.empty_cache()
    return err, ulps, ms, plain_ms, nbytes


# --------------------------------------------------------------------------- #
# K3 inputs and the kernel-vs-plain comparison
# --------------------------------------------------------------------------- #


def k3_inputs(M, n, gen, zero_rows=(), misalign=False):
    """x (M, n) with per-row magnitudes, U[0,1) draws u, scale absmax/127
    (0 on ``zero_rows``). ``misalign`` views x and u at an odd offset."""
    x = torch.randn((M, n), generator=gen, device=DEV)
    x.mul_(torch.rand((M, 1), generator=gen, device=DEV) * 10 + 1e-3)
    if zero_rows:
        x[list(zero_rows)] = 0.0
    u = torch.rand((M, n), generator=gen, device=DEV)
    if misalign:
        def shift(t):
            buf = torch.empty(t.numel() + 1, device=DEV)
            buf[1:] = t.reshape(-1)
            return buf[1:].view(M, n)
        x, u = shift(x), shift(u)
    return x, u, x.abs().amax(dim=1) / 127.0


def k3_diff(q, dec, wq, wdec):
    """(q mismatches, max abs, max ulp) of the kernel against its plain
    version."""
    bad = int((q != wq).sum())
    err, ulps = max_diff(dec, wdec)
    return bad, err, ulps


def k3_case(M, n, gen, zero_rows=(), misalign=False):
    x, u, s = k3_inputs(M, n, gen, zero_rows, misalign)
    wq, wdec = ref.quantize_update_ref(x, u, s)
    q, dec = qu.quantize_update_flat(x, u, s)
    torch.cuda.synchronize()
    return k3_diff(q, dec, wq, wdec)


def k3_big(M, n, gen, K=1 << 16):
    """One K3 launch with M·n > 2^31, held against the plain version on the
    head of the first row and the tail of the last."""
    check(M * n > 2 ** 31, "K3 big case is not above 2^31 elements")
    x, u, s = k3_inputs(M, n, gen)
    q, dec = qu.quantize_update_flat(x, u, s)
    torch.cuda.synchronize()
    worst = (0, 0.0, 0)
    for rows, cols in ((slice(0, 1), slice(0, K)),
                       (slice(M - 1, M), slice(n - K, n))):
        wq, wdec = ref.quantize_update_ref(x[rows, cols].contiguous(),
                                           u[rows, cols].contiguous(),
                                           s[rows])
        d = k3_diff(q[rows, cols], dec[rows, cols], wq, wdec)
        worst = tuple(max(a, b) for a, b in zip(worst, d))
    del x, u, s, q, dec
    torch.cuda.empty_cache()
    return worst


def k3_embed(gen, iters=20):
    """K3 at the embed.table leaf's shape: checked against its plain
    version, then both timed. Returns (diff, ms, plain ms, bytes)."""
    M, n = EMBED
    x, u, s = k3_inputs(M, n, gen)
    wq, wdec = ref.quantize_update_ref(x, u, s)
    q, dec = qu.quantize_update_flat(x, u, s)
    torch.cuda.synchronize()
    diff = k3_diff(q, dec, wq, wdec)
    del q, dec, wq, wdec
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: qu.quantize_update_flat(x, u, s), iters)
    plain_ms = cuda_ms(lambda: ref.quantize_update_ref(x, u, s), 5)
    del x, u, s
    torch.cuda.empty_cache()
    return diff, ms, plain_ms, k3_bytes(M, n)



# --------------------------------------------------------------------------- #
# K2: against its plain version, and on its path (the per-leaf step)
# --------------------------------------------------------------------------- #


def k2_inputs(n, gen, alpha=K2_STEP["alpha"], misalign=False):
    """p, m, g ~ N(0, 1) and d = |N(0, 1)| with every fifth element 0 and
    every seventh under α² (the clip is hit), (n,) fp32; ``misalign`` views
    each one float into its buffer (not 16-byte aligned: the scalar path)."""
    off = int(misalign)
    x = [torch.randn(n + off, generator=gen, device=DEV)[off:]
         for _ in range(4)]
    d = x[3].abs_()
    d[::5] = 0.0
    d[1::7] = 0.25 * alpha ** 2
    return x


def k2_case(n, squared, beta1, alpha, gen, misalign=False):
    """(max abs, max ulp) of K2 against its plain version."""
    x = k2_inputs(n, gen, alpha, misalign)
    kw = dict(gamma=0.05, beta1=beta1, alpha=alpha, squared=squared)
    want = ref.scaled_update_ref(*x, **kw)
    got = su.scaled_update_flat(*x, **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for w, g in zip(want, got):
        e, u = max_diff(w, g)
        err, ulps = max(err, e), max(ulps, u)
    return err, ulps


def k2_big(gen, misalign, chunk=1 << 26):
    """One K2 launch past 2^31 elements, diffed against the plain version
    over the whole array chunk by chunk (the plain version's temporaries stay
    one chunk wide; 6 arrays of 8.6 GB)."""
    n = K2_BIG
    check(n > 2 ** 31, "K2 big case is not above 2^31 elements")
    torch.cuda.empty_cache()
    x = k2_inputs(n, gen, misalign=misalign)
    kw = dict(gamma=0.05, beta1=0.9, alpha=K2_STEP["alpha"], squared=True)
    got = su.scaled_update_flat(*x, **kw)
    torch.cuda.synchronize()
    err, ulps = 0.0, 0
    for lo in range(0, n, chunk):
        want = ref.scaled_update_ref(*(t[lo:lo + chunk] for t in x), **kw)
        for w, g in zip(want, got):
            e, u = max_diff(w, g[lo:lo + chunk])
            err, ulps = max(err, e), max(ulps, u)
        del want
    del x, got
    torch.cuda.empty_cache()
    return n, err, ulps


def rand_tree(shapes, M, gen, positive=False):
    """{name: (M, *shape)} fp32 N(0, 1) leaves (|N(0, 1)| for a local D)."""
    tree = {k: torch.randn((M,) + tuple(shp), generator=gen, device=DEV)
            for k, shp in shapes.items()}
    if positive:
        tree = tree_map(torch.abs_, tree)
    return tree


def momentum_pass(mom, grads, beta1=K2_STEP["beta1"]):
    """m' = β₁m + g per leaf, the pre-refactor round's pass before K2."""
    return tree_map(lambda m, g: beta1 * m + g, mom, grads)


def per_leaf_step(params, mom, grads, d):
    """The pre-refactor round's scaled step: the momentum pass, then
    ``ops.scaled_update_tree`` (one K2 launch per leaf). Returns (params',
    m')."""
    mom2 = momentum_pass(mom, grads)
    return kops.scaled_update_tree(params, mom2, d, K2_STEP["gamma"],
                                   K2_STEP["alpha"]), mom2


def tree_step_check(params, mom2, d, newp):
    """The per-leaf step's params against the port's tree step p − γ·(m'/D̂)
    (``preconditioner.precondition``, the engine's order), element by
    element within 2⁻²¹·(|p'| + |γm'/D̂|): (γ·m')/D̂ and γ·(m'/D̂) each round
    twice, within 2⁻²³|γm'/D̂| of the exact step, and p − u once more, so
    the two differ by at most 2⁻²²|u| + 2⁻²³|p'|; the bound is twice that.
    Returns (elements beyond the bound, worst share of the bound)."""
    pc = PrecondConfig(kind="adam", alpha=K2_STEP["alpha"])
    bad, worst = 0, 0.0
    for k in params:
        upd = K2_STEP["gamma"] * PC.precondition(pc, {"d": d[k]}, mom2[k])
        want = params[k] - upd
        tol = 2.0 ** -21 * (want.abs() + upd.abs())
        diff = (newp[k] - want).abs()
        bad += int((diff > tol).sum())
        worst = max(worst, float((diff / tol.clamp_min(1e-38)).max()))
        del upd, want, tol, diff
    return bad, worst


def k2_path(name, shapes, M, gen):
    """K2 on the per-leaf step of one tree: the step (K2's count set to 0
    just before and read just after), held against the tree step, then
    timed (CUDA events, 10 steps): K2 alone (one launch a
    leaf on prepared inputs), its plain version, the whole per-leaf step
    (momentum pass, zeros, K2), and K1 (``fused_local_step``) on the same
    state flattened to (M, n) with a global D (client 0's) and with the
    local D. Returns a dict of the results."""
    params, mom, grads = (rand_tree(shapes, M, gen) for _ in range(3))
    d = rand_tree(shapes, M, gen, positive=True)
    su.scaled_update_flat.launches = 0
    newp, mom2 = per_leaf_step(params, mom, grads, d)
    launches = su.scaled_update_flat.launches
    torch.cuda.synchronize()
    check(launches == len(shapes), f"K2 launched {launches} times on "
          f"{name}, expected {len(shapes)} (one a leaf)")
    bad, worst = tree_step_check(params, mom2, d, newp)
    del newp
    n = sum(int(np.prod(s)) for s in shapes.values())
    out = {"name": name, "M": M, "n": n, "leaves": len(shapes), "bad": bad,
           "worst": worst, "launches": launches}
    torch.cuda.empty_cache()
    out["step_ms"] = cuda_ms(lambda: per_leaf_step(params, mom, grads, d),
                             10)
    flats = [(params[k].reshape(-1), torch.zeros_like(mom2[k]).reshape(-1),
              mom2[k].reshape(-1), d[k].reshape(-1)) for k in params]
    kw = dict(gamma=K2_STEP["gamma"], beta1=0.0, alpha=K2_STEP["alpha"])
    out["ms"] = cuda_ms(lambda: [su.scaled_update_flat(*f, **kw)
                                 for f in flats], 10)
    out["plain_ms"] = cuda_ms(lambda: [ref.scaled_update_ref(*f, **kw)
                                       for f in flats], 3)
    del flats, mom2
    torch.cuda.empty_cache()
    layout = FlatLayout.for_tree(params, batch_dims=1)
    bufs = {}
    for key, tree in (("p", params), ("m", mom), ("g", grads), ("d", d)):
        bufs[key] = layout.flatten(tree, batch_dims=1)
        tree.clear()                         # the flat copy replaces it
    del params, mom, grads, d
    torch.cuda.empty_cache()
    k1kw = dict(gamma=K2_STEP["gamma"], beta1=K2_STEP["beta1"],
                alpha=K2_STEP["alpha"], kind="adam")
    dg = bufs["d"][0].clone()
    out["k1_global_ms"] = cuda_ms(lambda: kops.fused_local_step(
        bufs["p"], bufs["m"], bufs["g"], dg, **k1kw), 10)
    out["k1_local_ms"] = cuda_ms(lambda: kops.fused_local_step(
        bufs["p"], bufs["m"], bufs["g"], bufs["d"], **k1kw), 10)
    del bufs, dg
    torch.cuda.empty_cache()
    # K2 moves p, m, g, d in and p', m' out: 24 bytes an element
    out["bytes"] = 24 * M * n
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def print_k2_path(r):
    print(f"[chip_smoke] K2 per-leaf step on {r['name']} (M={r['M']}, "
          f"n={r['n']}, {r['leaves']} leaves): against the tree step "
          f"p - g*(m'/D): {r['bad']} elements beyond 2^-21(|p'|+|u|), "
          f"worst at {r['worst']:.3f} of it; K2 alone {r['ms']:.4f} ms "
          f"({r['leaves']} launches), plain {r['plain_ms']:.4f} ms, whole "
          f"per-leaf step {r['step_ms']:.4f} ms, K1 global D "
          f"{r['k1_global_ms']:.4f} ms, K1 local D {r['k1_local_ms']:.4f} "
          f"ms, K2 bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e9:.3f} GB),"
          f" achieved {r['bytes'] / r['ms'] / 1e6:.1f} GB/s", flush=True)
    check(r["bad"] == 0, f"K2's per-leaf step differs from the tree step on "
          f"{r['name']}")


# --------------------------------------------------------------------------- #
# the paper's experiments (launch/paper.py)
# --------------------------------------------------------------------------- #


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def profile_fig1_round(method, fused, data, parts):
    """One steady Fig. 1 round (after a warm-up round) under the profiler:
    (kernel launches, device busy ms, wall ms)."""
    step, state, loader, _, _ = paper.fig1_setup(
        FIG1_FRAC, method, device=DEV, data=data, parts=parts,
        use_fused_kernel=fused)
    streams = paper.default_streams(0)
    for r in range(2):
        nb = paper.to_device(loader.round_batch(paper.FIG1["h_local"]), DEV)
        torch.cuda.synchronize()
        if r == 0:
            state, met = step(state, nb, streams(r))
            float(met["loss"])
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, met = step(state, nb, streams(r))
            float(met["loss"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return sum(e.count for e in kernels), busy, wall


def paper_phase():
    """fig1 at main_frac 0.5 for the five methods, 25 rounds, on the tree
    loop and on the fused loop (K1); thm1's transient case and sec52's six
    points on the fused loop, through ``launch/paper.py``. Every count is
    set to 0 just before a run and read just after."""
    data = paper.fig1_data(0)
    parts = main_class_partition(data.y[:-paper.FIG1["ntest"]],
                                 paper.FIG1["clients"], FIG1_FRAC, seed=0)
    H, R = paper.FIG1["h_local"], paper.FIG1["rounds"]
    rows = {}
    for fused in (False, True):
        su.fused_step_flat.launches = 0
        t0 = time.perf_counter()
        rows[fused] = {m: paper.fig1_run(FIG1_FRAC, m, device=DEV, data=data,
                                         parts=parts, use_fused_kernel=fused)
                       for m in paper.FIG1_METHODS}
        k1 = su.fused_step_flat.launches
        loop = "fused (K1)" if fused else "tree"
        want = len(paper.FIG1_METHODS) * R * H if fused else 0
        check(k1 == want, f"fig1 {loop}: K1 launched {k1} times, expected "
              f"{want}")
        print(f"[chip_smoke] fig1 main_frac {FIG1_FRAC}, {loop} loop: "
              f"{time.perf_counter() - t0:.1f} s for 5 methods x {R} rounds,"
              f" K1 launches {k1} ({H} a round)", flush=True)
        for m, rs in rows[fused].items():
            loss = [r["metrics"]["loss"] for r in rs]
            acc = [r["metrics"]["test_acc"] for r in rs]
            wall = [r["metrics"]["wall_s"] * 1e3 for r in rs[1:]]
            check(all(finite(v) for v in loss + acc), f"fig1 {m}: "
                  f"non-finite results")
            check(loss[-1] < loss[0], f"fig1 {m} ({loop}): round-{R - 1} "
                  f"loss {loss[-1]} is not below round 0's {loss[0]}")
            print(f"[chip_smoke]   {m}: loss {loss[0]:.4f} -> {loss[-1]:.4f}"
                  f", test acc {acc[-1]:.3f}; round wall (rounds 1-{R - 1})"
                  f" median {pct(wall, 50):.2f} ms, p90 {pct(wall, 90):.2f}"
                  f" ms; round 0 {rs[0]['metrics']['wall_s'] * 1e3:.1f} ms",
                  flush=True)
        summ = paper.summary("fig1", [r for rs in rows[fused].values()
                                      for r in rs])
        print(f"[chip_smoke]   summary ({loop}): {json.dumps(dict(summ))}",
              flush=True)
    worst = 0.0
    for m in paper.FIG1_METHODS:
        for a, b in zip(rows[True][m], rows[False][m]):
            la, lb = a["metrics"]["loss"], b["metrics"]["loss"]
            worst = max(worst, abs(la - lb) / abs(lb))
            check(abs(a["metrics"]["test_acc"] - b["metrics"]["test_acc"])
                  <= 2 / paper.FIG1["ntest"] + 1e-6, f"fig1 {m}: fused and "
                  f"tree test accuracy differ")
    print(f"[chip_smoke]   fused against tree: worst per-round loss "
          f"difference {worst:.3e} of the loss (bound {FIG1_TOL})",
          flush=True)
    check(worst <= FIG1_TOL, "fig1: fused and tree losses differ")
    for m in ("Adam global", "OASIS local"):
        for fused in (False, True):
            n_k, busy, wall = profile_fig1_round(m, fused, data, parts)
            print(f"[chip_smoke]   one traced fig1 round, {m}, "
                  f"{'fused' if fused else 'tree'}: {n_k} kernel launches, "
                  f"device busy {busy:.2f} ms of {wall:.2f} ms "
                  f"({busy / wall:.1%})", flush=True)
    for exp, argv, want in (
            ("thm1", ["--experiment", "transient"], 40 * 4),
            ("sec52", [], len(paper.SEC52_POINTS) * paper.SEC52["rounds"]
             * paper.SEC52["h_local"])):
        su.fused_step_flat.launches = 0
        t0 = time.perf_counter()
        out = paper.main(["--exp", exp, "--device", "cuda",
                          "--use-fused-kernel", *argv])[exp]
        k1 = su.fused_step_flat.launches
        vals = [v for r in out["rows"] for v in r["metrics"].values()]
        check(all(finite(float(v)) for v in vals), f"{exp}: non-finite rows")
        check(k1 == want, f"{exp}: K1 launched {k1} times, expected {want}")
        print(f"[chip_smoke] {exp} ({' '.join(argv) or 'six points'}), "
              f"fused loop: {time.perf_counter() - t0:.1f} s, K1 launches "
              f"{k1}, summary {json.dumps(out['summary'])}", flush=True)

# --------------------------------------------------------------------------- #
# K5 and K6 inputs and the kernel-vs-plain comparisons
# --------------------------------------------------------------------------- #


def k5_inputs(B, C, Hk, rep, D, gen, one_valid=False):
    """q fp32, k/v bf16 cache, and a causal bias at a random position per
    row (``one_valid``: every position but that one masked)."""
    q = torch.randn((B, Hk * rep, D), generator=gen, device=DEV)
    k = torch.randn((B, C, Hk, D), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, C, Hk, D), generator=gen, device=DEV).bfloat16()
    pos = torch.randint(0, C, (B,), generator=gen, device=DEV)
    idx = torch.arange(C, device=DEV)
    ok = idx[None] == pos[:, None] if one_valid else idx[None] <= pos[:, None]
    return q, k, v, torch.where(ok, 0.0, -1e30).float().contiguous()


def k5_case(B, C, Hk, rep, D, cap, gen, one_valid=False, at=None):
    """(max abs error, its bound 1e-5·max|v|) of K5 against its plain
    version. ``at``: every position but ``at`` masked in every row."""
    q, k, v, bias = k5_inputs(B, C, Hk, rep, D, gen, one_valid)
    if at is not None:
        bias.fill_(-1e30)
        bias[:, at] = 0.0
    want = ref.decode_attention_ref(q, k, v, bias, softcap=cap)
    got = ds.decode_attention(q, k, v, bias, softcap=cap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bound = 1e-5 * float(v.float().abs().max())
    del q, k, v, bias, want, got
    return err, bound


def k5_bytes(B, C, Hk, rep, D):
    """Bytes K5 must move: read q, k, v and bias, write out."""
    H = Hk * rep
    return 4 * B * H * D + 2 * 2 * B * C * Hk * D + 4 * B * C + 4 * B * H * D


# the heads K6 samples from: (V, v_real, d, table scale, logit scale) of
# qwen2-0.5b's tied table and mamba2-1.3b's untied head
QWEN_HEAD = (V_PAD, V_REAL, D_MODEL, 0.02, D_MODEL ** -0.5)
MAMBA_HEAD = (51_200, 50_280, 2048, 2048 ** -0.5, 1.0)


def k6_inputs(B, gen, greedy, head=QWEN_HEAD):
    V, _, d, tscale, _ = head
    y = torch.randn((B, d), generator=gen, device=DEV)
    table = torch.randn((V, d), generator=gen, device=DEV) * tscale
    noise = torch.zeros((B, V), device=DEV) if greedy else \
        rng.gumbel_from_uniform(torch.rand((B, V), generator=gen,
                                           device=DEV))
    return y, table, noise


def k6_case(B, greedy, gen, dup=None, pad=False, head=QWEN_HEAD):
    """K6 against its plain version under the near-tie rule. ``dup``: two
    table rows made identical and best for row 0 (the lower index must
    win); ``pad``: a padded id that would win row 1 if it were not masked.
    Returns (exceptions, violations, max abs difference of the winning
    logit)."""
    _, v_real, _, _, scale = head
    y, table, noise = k6_inputs(B, gen, greedy, head)
    if dup:
        table[dup[0]] = table[dup[1]] = y[0] / y[0].norm() * 5.0
    if pad:
        table[v_real + 9] = y[1] / y[1].norm() * 50.0
    logits = ref.decode_sample_logits(y, table, noise, scale=scale,
                                      v_real=v_real)
    want, wbest = ref.decode_sample_ref(y, table, noise, scale=scale,
                                        v_real=v_real, return_best=True)
    got, best = ds.decode_sample(y, table, noise, scale=scale, v_real=v_real,
                                 return_best=True)
    torch.cuda.synchronize()
    ties, bad = ref.near_tie_check(logits, got, want, v_real)
    err = float((best - wbest).abs().max())
    if dup:
        check(int(got[0]) == dup[0] == int(want[0]),
              f"K6 duplicated rows {dup}: got id {int(got[0])}")
    if pad:
        check(int(got.max()) < v_real, "K6 chose a padded id")
    del y, table, noise, logits
    return ties, bad, err


def k6_bytes(B, v_real=V_REAL, d=D_MODEL):
    """Bytes K6 must move: the real table rows, the real noise columns and
    y, and the ids written."""
    return 4 * (v_real * d + B * v_real + B * d + B)


def time_k5(shape, gen, splits=()):
    """K5 at ``shape`` (B, C, Hk, rep, D): CUDA-event times of the kernel
    wrapper (its two launches), its plain version and SDPA (the bias as
    mask over fp32 k/v, GQA), each timed back to back as every kernel is
    (``ms``: where a call's host work outlasts its device work, the host
    sets it) and as device time (``device_ms``, ``graph_ms``); the
    wrapper's two times with its plan swapped for each split length in
    ``splits`` and the plan's own (``split_ms``: {split: (ms, device_ms)});
    and its bound."""
    B, C, Hk, rep, D = shape
    q, k, v, bias = k5_inputs(B, C, Hk, rep, D, gen)
    q4 = q[:, :, None, :]
    kf = k.float().transpose(1, 2).contiguous()      # (B, Hk, C, D)
    vf = v.float().transpose(1, 2).contiguous()
    mask = bias[:, None, None, :]
    lib = F.scaled_dot_product_attention(q4, kf, vf, attn_mask=mask,
                                         enable_gqa=True)[:, :, 0]
    check(float((lib - ref.decode_attention_ref(q, k, v, bias)).abs().max())
          <= 1e-4, "SDPA does not compute K5's function")
    fns = {"": (lambda: ds.decode_attention(q, k, v, bias), 200),
           "plain_": (lambda: ref.decode_attention_ref(q, k, v, bias), 100),
           "library_": (lambda: F.scaled_dot_product_attention(
               q4, kf, vf, attn_mask=mask, enable_gqa=True), 200)}
    k5 = {}
    for key, (fn, iters) in fns.items():
        k5[key + "ms"] = cuda_ms(fn, iters)
        k5[key + "device_ms"] = graph_ms(fn)
    plan = ds.attention_plan
    k5["plan"], k5["split_ms"] = plan(B, Hk, C)[0], {}
    try:
        for split in sorted({k5["plan"], *splits}):
            ds.attention_plan = lambda B_, Hk_, C_, s=split: (s, -(-C_ // s))
            k5["split_ms"][split] = (cuda_ms(fns[""][0], 200),
                                     graph_ms(fns[""][0]))
    finally:
        ds.attention_plan = plan
    k5["bytes"] = k5_bytes(B, C, Hk, rep, D)
    k5["bound_ms"] = k5["bytes"] / HBM_BYTES_PER_S * 1e3
    del q, k, v, bias, kf, vf, lib
    torch.cuda.empty_cache()
    return k5


def time_k6(gen, B=SERVE["batch"], head=QWEN_HEAD):
    """K6 at a serve path's shape: CUDA-event times of the kernel wrapper,
    its plain version and matmul·scale + noise, masked, argmax."""
    V, v_real, d, _, scale = head
    y, table, noise = k6_inputs(B, gen, True, head)
    pad = torch.arange(V, device=DEV) >= v_real

    def library():
        lg = torch.matmul(y, table.T) * scale + noise
        return lg.masked_fill_(pad, float("-inf")).argmax(dim=1)

    k6 = {"ms": cuda_ms(lambda: ds.decode_sample(y, table, noise,
                                                 scale=scale,
                                                 v_real=v_real), 50),
          "plain_ms": cuda_ms(lambda: ref.decode_sample_ref(
              y, table, noise, scale=scale, v_real=v_real), 5),
          "library_ms": cuda_ms(library, 50),
          "bytes": k6_bytes(B, v_real, d)}
    flops = 2 * B * v_real * d
    k6["bound_ms"] = max(k6["bytes"] / HBM_BYTES_PER_S,
                         flops / FP32_FLOP_PER_S) * 1e3
    del y, table, noise
    torch.cuda.empty_cache()
    return k6


# --------------------------------------------------------------------------- #
# K4 inputs, the kernel-vs-plain comparison and its timing
# --------------------------------------------------------------------------- #


def k4_inputs(B, S, H, Hk, D, dtype, gen):
    return [torch.randn(shape, generator=gen, device=DEV).to(dtype)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))]


def k4_plain(q, k, v, window=0, softcap=0.0):
    """K4's plain version, one batch row at a time: at the prefill's shape
    one row's (H, S, S) fp32 scores are 3.8 GB."""
    return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1],
                                              v[b:b + 1], window=window,
                                              softcap=softcap)
                      for b in range(q.shape[0])])


def k4_case(B, S, H, Hk, D, window, cap, dtype, gen):
    """(max abs error, its bound) of K4 against its plain version: 2e-5 of
    max|v| in fp32, 1e-2 in bf16 (both round the output to bf16)."""
    q, k, v = k4_inputs(B, S, H, Hk, D, dtype, gen)
    want = k4_plain(q, k, v, window, cap)
    got = fa.flash_attention(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    check(got.shape == (B, S, H, D) and got.dtype == dtype,
          f"K4 output {tuple(got.shape)} {got.dtype}")
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    bound = tol * float(v.float().abs().max())
    del q, k, v, want, got
    torch.cuda.empty_cache()
    return err, bound


def k4_work(B, S, H, Hk, D):
    """(flops, bytes) K4 must do at a causal shape without a window: two
    D-long dots per causal pair; read q, k, v once, write out."""
    pairs = B * H * S * (S + 1) // 2
    return 4 * D * pairs, 4 * (2 * B * S * H * D + 2 * B * S * Hk * D)


def time_k4(gen):
    """K4 at the prefill's shape: CUDA-event times of the kernel wrapper,
    its plain version (row by row), the port's chunked ``models/flash.py``
    forward (KV repeated to H heads beforehand, blocks of 1024, as the
    model's plain route runs it) and SDPA (fp32, causal, GQA), and its
    bound."""
    B, S, H, Hk, D = K4_MAIN
    q, k, v = k4_inputs(B, S, H, Hk, D, torch.float32, gen)
    out = fa.flash_attention(q, k, v)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    err = float((lib - out).abs().max())
    check(err <= 1e-4 * float(v.abs().max()),
          f"SDPA does not compute K4's function ({err:.3e})")
    del lib, out
    torch.cuda.empty_cache()
    t = {"ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 10),
         "plain_ms": cuda_ms(lambda: k4_plain(q, k, v), 2),
         "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True, enable_gqa=True), 5)}
    pos = torch.arange(S, device=DEV)
    kr, vr = (torch.repeat_interleave(x, H // Hk, dim=2) for x in (k, v))
    with torch.no_grad():
        t["chunked_ms"] = cuda_ms(lambda: flash_attention_bshd(
            q, kr, vr, pos, pos, bq=1024, bk=1024), 2)
    t["flops"], t["bytes"] = k4_work(B, S, H, Hk, D)
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOP_PER_S) * 1e3
    del q, k, v, qt, kt, vt, kr, vr
    torch.cuda.empty_cache()
    return t


# --------------------------------------------------------------------------- #
# K7 inputs, the kernel-vs-plain comparison and its timing
# --------------------------------------------------------------------------- #


def k7_inputs(B, S, H, P, N, a, shared, gen):
    """x, B, C ~ N(0, 1), dt = softplus(N(0, 1)), A = -linspace(1, 16) (the
    model's A_log range) or ``a`` on every head; ``shared``: True for one
    B/C group expanded over the heads, "B" for B alone (C per head)."""
    f = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    x = f(B, S, H, P)
    dt = F.softplus(f(B, S, H))
    A = torch.full((H,), a, device=DEV) if a is not None else \
        -torch.linspace(1.0, 16.0, H, device=DEV)
    Bm = f(B, S, 1, N).expand(B, S, H, N) if shared else f(B, S, H, N)
    Cm = f(B, S, 1, N).expand(B, S, H, N) if shared is True \
        else f(B, S, H, N)
    return x, dt, A, Bm, Cm


def cum_max(dt, A, Q):
    """max over cells of |cumsum(dt·A)|: the largest chunk sum of |dt·A|."""
    B, S, H = dt.shape
    return float((dt * A.abs()).reshape(B, S // Q, Q, H).sum(2).max())


def k7_eps(cmax, N, Q):
    """K7's relative bound against its plain version, of the magnitude sum
    (the plain version on |x|, |B|, |C|), u = 2^-24: both sum N products for
    C·Bᵀ and up to Q for the rest, within (N + Q)·u each; their exps differ
    by <= 2 ulps; cum, an fp64 sum rounded once on both sides, differs by
    one ulp only where two fp64 sums straddle an fp32 rounding boundary,
    which moves an L by <= 4u·max|cum|."""
    return U * (4 * cmax + 2 * (N + Q) + 16)


def k7_case(B, S, H, P, N, Q, a, shared, gen):
    """K7 against its plain version element by element, and a second call
    against the first bit for bit. Returns (max abs error, the worst ratio
    of an error to its bound, eps, max|cum|, G groups)."""
    x, dt, A, Bm, Cm = k7_inputs(B, S, H, P, N, a, shared, gen)
    want = ref.ssd_intra_chunk_ref(x, dt, A, Bm, Cm, Q)
    got = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    again = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(got, again)),
          "two K7 calls on the same inputs differ")
    groups = ssd.plan(B, S, H, P, N, Q, Bm.stride(), Cm.stride()).groups
    cmax = cum_max(dt, A, Q)
    eps = k7_eps(cmax, N, Q)
    mags = ref.ssd_intra_chunk_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), Q)
    nc = S // Q
    err = ratio = 0.0
    for g, w, m, shape in zip(got, want, mags,
                              ((B, S, H, P), (B, nc, H, N, P), (B, nc, H))):
        check(g.shape == shape and g.dtype == torch.float32,
              f"K7 output {tuple(g.shape)} {g.dtype}")
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (eps * m).clamp_min(1e-30)).max()))
    del x, dt, A, Bm, Cm, want, got, again, mags
    torch.cuda.empty_cache()
    return err, ratio, eps, cmax, groups


def time_k7(gen, shape=K7_MAIN):
    """K7 at a serve path's shape (B/C one group over the heads, as the
    model passes them; A as the model's): CUDA-event times of the kernel
    wrapper (two launches a call) back to back and as device time (a CUDA
    graph of calls), of its plain version and of the whole plain SSD
    (``models.ssm.ssd_chunked``), and its bound from ``ssd_scan.work``
    with the plan's groups. No single PyTorch call computes K7's function:
    no library time."""
    B, S, H, P, N, Q = shape
    x, dt, A, Bm, Cm = k7_inputs(B, S, H, P, N, None, True, gen)
    t = {"ms": cuda_ms(lambda: ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q), 20),
         "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_ref(x, dt, A, Bm,
                                                             Cm, Q), 3),
         "chunked_ms": cuda_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, Q), 3),
         "route_ms": cuda_ms(lambda: kops.ssd(x, dt, A, Bm, Cm, chunk=Q), 5),
         "device_ms": graph_ms(lambda: ssd.ssd_intra_chunk(x, dt, A, Bm, Cm,
                                                           Q),
                               calls=10 if B * S > 2048 else 50)}
    t["groups"] = ssd.plan(B, S, H, P, N, Q, Bm.stride(), Cm.stride()).groups
    t["flops"], t["bytes"] = ssd.work(B, S, H, P, N, Q, t["groups"])
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOP_PER_S) * 1e3
    del x, dt, A, Bm, Cm
    torch.cuda.empty_cache()
    return t


# --------------------------------------------------------------------------- #
# serving phases
# --------------------------------------------------------------------------- #


def serve_params():
    """The weights ``serve`` makes for seed 0 at full width."""
    cfg = get_config("qwen2-0.5b")
    return cfg, build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(0))


def serve_main_path():
    """``serve`` at full width with K5 and K6, counts set to 0 just before
    and read just after. Returns (result, K5 launches, K6 launches, peak
    GiB)."""
    ds.decode_attention.launches = 0
    ds.decode_sample.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve_mod.serve("qwen2-0.5b", reduced=False, use_decode_kernel=True,
                          device="cuda", verbose=False, **SERVE)
    k5, k6 = ds.decode_attention.launches, ds.decode_sample.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = SERVE["gen_len"] - 1
    t = res.timings
    print(f"[chip_smoke]   TTFT (prefill, B={SERVE['batch']}, S="
          f"{SERVE['prompt_len']}) {t['prefill_s'] * 1e3:.3f} ms; decode "
          f"{steps} steps {t['decode_s']:.4f} s, median step "
          f"{float(np.median(res.per_token_s)) * 1e3:.3f} ms; "
          f"{t['tok_per_s']:.1f} tokens/s; peak memory {peak:.2f} GiB; "
          f"launches K5 {k5}, K6 {k6}", flush=True)
    check(res.tokens.shape == (SERVE["batch"], SERVE["gen_len"]),
          f"tokens {res.tokens.shape}")
    check(0 <= int(res.tokens.min()) and int(res.tokens.max()) < V_REAL,
          "an id outside the real vocabulary")
    check(k5 == K5_PER_CALL * 24 * steps,
          f"K5 launched {k5} times, expected {K5_PER_CALL * 24 * steps}")
    check(k6 == steps, f"K6 launched {k6} times, expected {steps}")
    return res, k5, k6, peak


def teacher_forced(cfg, params):
    """Kernel path against plain path at full width on one prompt: each
    step both paths get the plain path's greedy token; the kernel path's
    ids are held to the plain logits under the near-tie rule. Returns
    (exceptions, ids compared)."""
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        logits, cache_p = plain.prefill_cache(params, prompt, S + G)
        cache_k = {k: v.clone() for k, v in cache_p.items()}
        tok = sample_ids(logits, 0.0, cfg.vocab_size)
        zeros = torch.zeros_like(logits)
        head = kern.sample_head(params)
        ties = 0
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"teacher-forced step {g}: kernel ids break the "
                  f"near-tie rule")
            ties += t
            tok = want
    return ties, B * (G - 1)


def continuous_path(cfg, params):
    """``serve_continuous`` at full width with K5 and K6 (counts set to 0
    just before), then three of its requests held against solo serving,
    teacher-forced on the ring's tokens under the near-tie rule (a B=1
    decode runs other cuBLAS kernels than the ring's B=8 one). Returns
    (result, K5 launches, K6 launches, exceptions, ids compared)."""
    ds.decode_attention.launches = 0
    ds.decode_sample.launches = 0
    res = serve_mod.serve_continuous("qwen2-0.5b", reduced=False,
                                     use_decode_kernel=True, device="cuda",
                                     verbose=False, **TRACE)
    k5, k6 = ds.decode_attention.launches, ds.decode_sample.launches
    m = res.metrics
    print(f"[chip_smoke]   {m['n_requests']} requests / {m['slots']} slots: "
          f"{m['total_tokens']} tokens in {m['makespan_steps']} steps "
          f"({m['tok_per_step']:.3f} tokens/step), {m['decode_steps']} "
          f"decode steps, p50 step {m['p50_step_s'] * 1e3:.3f} ms, p99 "
          f"{m['p99_step_s'] * 1e3:.3f} ms, wall {m['wall_s']:.3f} s "
          f"({m['wall_tok_per_s']:.1f} tokens/s), prefill "
          f"{m['prefill_s']:.3f} s, mean queue delay "
          f"{m['mean_queue_delay_steps']:.3f} steps; launches K5 {k5}, K6 "
          f"{k6}", flush=True)
    check(all(rq["finish"] is not None for rq in res.requests.values()),
          "a request did not finish")
    _, gens = serve_mod.poisson_trace(TRACE["n_requests"],
                                      TRACE["arrival_rate"], TRACE["seed"],
                                      TRACE["gen_len"])
    check([len(res.tokens[r]) for r in range(TRACE["n_requests"])]
          == [int(g) for g in gens], "a request got the wrong token count")
    check(k5 == K5_PER_CALL * 24 * m["decode_steps"]
          and k6 == m["decode_steps"],
          f"launches K5 {k5}, K6 {k6} for {m['decode_steps']} steps")
    S, G = TRACE["prompt_len"], TRACE["gen_len"]
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    ties = compared = 0
    with torch.inference_mode():
        for r in (0, 7, 15):
            ring = torch.from_numpy(res.tokens[r]).to(DEV)
            prompt = serve_mod.request_prompt(cfg, TRACE["seed"], r, S, DEV)
            logits, cache = kern.prefill_cache(params, prompt, S + G)
            first = sample_ids(logits, 0.0, cfg.vocab_size)
            check(int(first[0]) == int(ring[0]),
                  f"request {r}: first token differs from solo prefill")
            for g in range(1, len(ring)):
                lg, cache = kern.decode(params, cache, ring[g - 1:g],
                                        S + g - 1)
                want = sample_ids(lg, 0.0, cfg.vocab_size)
                t, bad = ref.near_tie_check(lg, ring[g:g + 1], want,
                                            cfg.vocab_size)
                check(bad == 0, f"request {r} step {g}: ring token breaks "
                      f"the near-tie rule against solo serving")
                ties += t
                compared += 1
    return res, k5, k6, ties, compared


def long_serve_path():
    """``serve`` at full width on an 8192-token prompt with K4 in the
    prefill and K5/K6 in decode, counts set to 0 just before and read just
    after. Returns (result, K4, K5, K6 launches, peak GiB)."""
    fa.flash_attention.launches = 0
    ds.decode_attention.launches = 0
    ds.decode_sample.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve_mod.serve("qwen2-0.5b", reduced=False, use_flash_kernel=True,
                          use_decode_kernel=True, device="cuda",
                          verbose=False, **LONG)
    k4 = fa.flash_attention.launches
    k5, k6 = ds.decode_attention.launches, ds.decode_sample.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = LONG["gen_len"] - 1
    t = res.timings
    print(f"[chip_smoke]   TTFT (prefill, B={LONG['batch']}, S="
          f"{LONG['prompt_len']}) {t['prefill_s'] * 1e3:.3f} ms; decode "
          f"{steps} steps {t['decode_s']:.4f} s, median step "
          f"{float(np.median(res.per_token_s)) * 1e3:.3f} ms; "
          f"{t['tok_per_s']:.2f} tokens/s; peak memory {peak:.2f} GiB; "
          f"launches K4 {k4}, K5 {k5}, K6 {k6}", flush=True)
    check(res.tokens.shape == (LONG["batch"], LONG["gen_len"]),
          f"tokens {res.tokens.shape}")
    check(0 <= int(res.tokens.min()) and int(res.tokens.max()) < V_REAL,
          "an id outside the real vocabulary")
    check(k4 == 24, f"K4 launched {k4} times, expected 24")
    check(k5 == K5_PER_CALL * 24 * steps,
          f"K5 launched {k5} times, expected {K5_PER_CALL * 24 * steps}")
    check(k6 == steps, f"K6 launched {k6} times, expected {steps}")
    return res, k4, k5, k6, peak


def long_teacher_forced(cfg, params):
    """The K4 path (K4 prefill, K5/K6 decode) against the plain path (the
    chunked ``models/flash.py`` prefill, dense decode) at full width on the
    long prompt, teacher-forced on the plain path's greedy tokens. Held:
    last-position logits within 1e-4·max|logit|, the bf16 caches within
    2^-7·max|cache| (one bf16 ulp at the top binade), every id under the
    near-tie rule. Returns (logit error, its bound, cache error, the
    largest ratio of a layer's cache error to its bound, near-tie
    exceptions, ids compared)."""
    B, S, G = LONG["batch"], LONG["prompt_len"], LONG["gen_len"]
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_flash_kernel=True,
                                            use_decode_kernel=True))
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        lerr = float((lg_k - lg_p).abs().max())
        lbound = 1e-4 * float(lg_p.abs().max())
        check(lerr <= lbound, f"long prefill logits differ by {lerr:.3e} "
              f"(bound {lbound:.3e})")
        cerr = cratio = 0.0
        for key in ("k", "v"):
            for i, (a, b) in enumerate(zip(cache_k[key], cache_p[key])):
                e = float((a.float() - b.float()).abs().max())
                bound = 2.0 ** -7 * float(b.float().abs().max())
                check(e <= bound, f"long prefill cache {key}, layer {i}: "
                      f"differs by {e:.3e} (bound {bound:.3e})")
                cerr, cratio = max(cerr, e), max(cratio, e / bound)
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        ties, bad = ref.near_tie_check(lg_p, sample_ids(lg_k, 0.0,
                                                        cfg.vocab_size),
                                       want, cfg.vocab_size)
        check(bad == 0, "long prefill: K4 path's first ids break the "
              "near-tie rule")
        tok = want
        zeros = torch.zeros_like(lg_p)
        head = kern.sample_head(params)
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"long prompt, teacher-forced step {g}: K4 "
                  f"path's ids break the near-tie rule")
            ties += t
            tok = want
    del cache_p, cache_k
    torch.cuda.empty_cache()
    return lerr, lbound, cerr, cratio, ties, B * G


def mamba_params():
    """The weights ``serve`` makes for seed 0 at mamba2-1.3b's full width."""
    cfg = get_config("mamba2-1.3b")
    return cfg, build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(0))


def mamba_serve_path():
    """``serve`` of full-width mamba2-1.3b with K7 in the prefill and K6 in
    decode, counts set to 0 just before and read just after. Returns
    (result, K7, K6 launches, peak GiB)."""
    ssd.ssd_intra_chunk.launches = 0
    ds.decode_attention.launches = 0
    ds.decode_sample.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    res = serve_mod.serve("mamba2-1.3b", reduced=False, use_ssd_kernel=True,
                          use_decode_kernel=True, device="cuda",
                          verbose=False, **MAMBA)
    k7, k6 = ssd.ssd_intra_chunk.launches, ds.decode_sample.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = MAMBA["gen_len"] - 1
    t = res.timings
    print(f"[chip_smoke]   TTFT (prefill, B={MAMBA['batch']}, S="
          f"{MAMBA['prompt_len']}) {t['prefill_s'] * 1e3:.3f} ms; decode "
          f"{steps} steps {t['decode_s']:.4f} s, median step "
          f"{float(np.median(res.per_token_s)) * 1e3:.3f} ms; "
          f"{t['tok_per_s']:.2f} tokens/s; peak memory {peak:.2f} GiB "
          f"({held:.2f} GiB held by the script before the phase); "
          f"launches K7 {k7}, K6 {k6}, K5 {ds.decode_attention.launches}",
          flush=True)
    check(res.tokens.shape == (MAMBA["batch"], MAMBA["gen_len"]),
          f"tokens {res.tokens.shape}")
    check(0 <= int(res.tokens.min()) and int(res.tokens.max())
          < MAMBA_HEAD[1], "an id outside mamba2's real vocabulary")
    check(k7 == N_MAMBA_LAYERS, f"K7 launched {k7} times, expected "
          f"{N_MAMBA_LAYERS}")
    check(k6 == steps, f"K6 launched {k6} times, expected {steps}")
    check(ds.decode_attention.launches == 0, "K5 ran in an attention-free "
          "model")
    return res, k7, k6, peak


class CumRecorder:
    """Wraps ``ops.ssd`` (the K7 route's entry) and records the largest
    |cum| of every call, for the teacher-forced bound."""

    def __init__(self):
        self.max, self.real = 0.0, kops.ssd

    def __call__(self, xh, dt, A, Bm, Cm, *, chunk, h0=None):
        self.max = max(self.max, cum_max(dt, A, chunk))
        return self.real(xh, dt, A, Bm, Cm, chunk=chunk, h0=h0)


def mamba_teacher_forced(cfg, params):
    """The K7 route (K7 prefill, K6 decode) against the plain route
    (``ssd_chunked`` prefill, plain decode) at full width on one prompt,
    teacher-forced on the plain route's greedy tokens. Held, with
    eps = u·(4·max|cum| + N + Q + 2·nc + 8), u = 2^-24, max|cum| recorded
    over the prefill's 48 SSD calls (both routes accumulate cum in fp64 and
    round it once, so cum differs by at most one ulp, which moves an L by
    <= 4u·max|cum|; the products add (N + Q)·u, the chunk recurrence 2u per
    chunk; the fp32 projections and norms around the SSD add ~d·u, far
    below): last-position logits within eps·max|logit|, every leaf of the
    decode cache (h, conv tails) within eps of its largest value, every id
    under the near-tie rule. Returns (logit error, its bound, the worst
    ratio of a cache leaf's error to its bound, near-tie exceptions, ids
    compared, max|cum|)."""
    B, S, G = MAMBA["batch"], MAMBA["prompt_len"], MAMBA["gen_len"]
    s = cfg.ssm
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_ssd_kernel=True,
                                            use_decode_kernel=True))
    rec = CumRecorder()
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        kops.ssd = rec
        try:
            lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        finally:
            kops.ssd = rec.real
        eps = U * (4 * rec.max + s.d_state + s.chunk + 2 * (S // s.chunk)
                   + 8)
        lerr = float((lg_k - lg_p).abs().max())
        lbound = eps * float(lg_p.abs().max())
        check(lerr <= lbound, f"mamba2 prefill logits differ by {lerr:.3e} "
              f"(bound {lbound:.3e})")
        cratio = 0.0
        for key, want in cache_p["mamba"].items():
            e = float((cache_k["mamba"][key] - want).abs().max())
            bound = eps * float(want.abs().max())
            check(e <= bound, f"mamba2 prefill cache {key}: differs by "
                  f"{e:.3e} (bound {bound:.3e})")
            cratio = max(cratio, e / bound)
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        ties, bad = ref.near_tie_check(lg_p, sample_ids(lg_k, 0.0,
                                                        cfg.vocab_size),
                                       want, cfg.vocab_size)
        check(bad == 0, "mamba2 prefill: K7 route's first ids break the "
              "near-tie rule")
        tok = want
        zeros = torch.zeros_like(lg_p)
        head = kern.sample_head(params)
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"mamba2 teacher-forced step {g}: K7/K6 route's "
                  f"ids break the near-tie rule")
            ties += t
            tok = want
    del cache_p, cache_k, head
    torch.cuda.empty_cache()
    return lerr, lbound, cratio, ties, B * G, rec.max


def mamba_continuous(cfg, params):
    """``serve_continuous`` of full-width mamba2-1.3b with K7 and K6 (counts
    set to 0 just before), then three of its requests held against solo
    serving, teacher-forced on the ring's tokens under the near-tie rule.
    Each admission's B=1 prefill cache tree goes into its slot through
    ``insert_slot``. Returns (result, K7, K6 launches, exceptions, ids
    compared)."""
    ssd.ssd_intra_chunk.launches = 0
    ds.decode_sample.launches = 0
    res = serve_mod.serve_continuous("mamba2-1.3b", reduced=False,
                                     use_ssd_kernel=True,
                                     use_decode_kernel=True, device="cuda",
                                     verbose=False, **MTRACE)
    k7, k6 = ssd.ssd_intra_chunk.launches, ds.decode_sample.launches
    m = res.metrics
    print(f"[chip_smoke]   {m['n_requests']} requests / {m['slots']} slots: "
          f"{m['total_tokens']} tokens in {m['makespan_steps']} steps "
          f"({m['tok_per_step']:.3f} tokens/step), {m['decode_steps']} "
          f"decode steps, p50 step {m['p50_step_s'] * 1e3:.3f} ms, p99 "
          f"{m['p99_step_s'] * 1e3:.3f} ms, wall {m['wall_s']:.3f} s "
          f"({m['wall_tok_per_s']:.1f} tokens/s), prefill "
          f"{m['prefill_s']:.3f} s; launches K7 {k7}, K6 {k6}", flush=True)
    n = MTRACE["n_requests"]
    check(all(rq["finish"] is not None for rq in res.requests.values()),
          "a request did not finish")
    _, gens = serve_mod.poisson_trace(n, MTRACE["arrival_rate"],
                                      MTRACE["seed"], MTRACE["gen_len"])
    check([len(res.tokens[r]) for r in range(n)] == [int(g) for g in gens],
          "a request got the wrong token count")
    check(k7 == N_MAMBA_LAYERS * n and k6 == m["decode_steps"],
          f"launches K7 {k7}, K6 {k6} for {n} prefills and "
          f"{m['decode_steps']} steps")
    check(all(int(t.max()) < MAMBA_HEAD[1] for t in res.tokens.values()),
          "an id outside mamba2's real vocabulary")
    S, G = MTRACE["prompt_len"], MTRACE["gen_len"]
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_ssd_kernel=True))
    ties = compared = 0
    with torch.inference_mode():
        for r in (0, 7, 15):
            ring = torch.from_numpy(res.tokens[r]).to(DEV)
            prompt = serve_mod.request_prompt(cfg, MTRACE["seed"], r, S, DEV)
            logits, cache = kern.prefill_cache(params, prompt, S + G)
            first = sample_ids(logits, 0.0, cfg.vocab_size)
            check(int(first[0]) == int(ring[0]),
                  f"mamba2 request {r}: first token differs from solo")
            for g in range(1, len(ring)):
                lg, cache = kern.decode(params, cache, ring[g - 1:g],
                                        S + g - 1)
                want = sample_ids(lg, 0.0, cfg.vocab_size)
                t, bad = ref.near_tie_check(lg, ring[g:g + 1], want,
                                            cfg.vocab_size)
                check(bad == 0, f"mamba2 request {r} step {g}: ring token "
                      f"breaks the near-tie rule against solo serving")
                ties += t
                compared += 1
    return res, k7, k6, ties, compared


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def finite(v):
    return v == v and abs(v) != float("inf")


def main_path(argv, expect_k1, expect_k3=0):
    """Drive ``train.main(argv)`` with the kernels' counts set to 0 just
    before and read just after; returns (log, K1 launches, K3 launches,
    peak GiB). ``expect_k1`` is a count, or a function of the log (the
    launches the realized H_m need: one a local step in which any client is
    active, Σ_r max_m H_m,r)."""
    su.fused_step_flat.launches = 0
    qu.quantize_update_flat.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = train.main(argv)
    k1, k3 = su.fused_step_flat.launches, qu.quantize_update_flat.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for rec in log:
        extra = (f" comp_err {rec['compression_err']:.4e}"
                 if "compression_err" in rec else "")
        extra += (f" staleness {rec['staleness']:.4f}"
                  if "staleness" in rec else "")
        extra += (f" H_m {rec['ctrl_h_m']} H_t {rec['ctrl_h_t']} k "
                  f"{rec['ctrl_k']} b_eff {rec['ctrl_b_eff']}"
                  if "ctrl_h_m" in rec else "")
        print(f"[chip_smoke]   round {rec['round']} loss {rec['loss']:.5f} "
              f"drift {rec['drift']:.4e}{extra} tokens/s "
              f"{rec['tokens_per_s']} wall {rec['wall_s']} s", flush=True)
        check(all(finite(v) for v in rec.values() if isinstance(v, float)),
              f"non-finite record {rec}")
        check("staleness" not in rec or rec["staleness"] >= 0.0,
              f"staleness {rec.get('staleness')}")
    if callable(expect_k1):
        expect_k1 = expect_k1(log)
    check(k1 == expect_k1, f"K1 launched {k1} times, expected {expect_k1}")
    check(k3 == expect_k3, f"K3 launched {k3} times, expected {expect_k3}")
    print(f"[chip_smoke]   launches K1 {k1}, K3 {k3}; peak memory "
          f"{peak:.2f} GiB", flush=True)
    return log, k1, k3, peak


def fused_vs_tree(name, rounds=1, flips=False, H=2, **method_kw):
    """``rounds`` rounds at full width and 2 layers: fused client loop
    against the tree loop from the same start, same batches, same rng
    streams. Every float leaf must agree to 1e-5 of its scale (the EF
    residual's and the staleness FIFO's scale is the matching params leaf's:
    u − C(u) and the averaged deltas x̄ − x_t cancel to ulps of the params). ``flips`` (int8 rounds): where the two loops' deltas
    differ in the last bits at an integer boundary, floor(v + u) flips q by
    one; up to 1e-4 of a leaf's elements may then differ by up to 2e-4 of
    its scale. Returns (worst relative difference, flipped elements, K1
    launches of the fused run)."""
    cfg = get_config("qwen2-0.5b").replace(n_layers=2)
    model = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    M, b, S = 4, 8, 128
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=0), M, b)
    root = rng.TorchStream(1)
    out = {}
    for fused in (True, False):
        spec = engine.method_spec("savic", gamma=3e-3, use_fused_kernel=fused,
                                  **method_kw)
        gen = torch.Generator(device=DEV).manual_seed(0)
        state = engine.init_state(gen, model.init, spec, M)
        step = engine.build_round_step(model.loss, spec)
        su.fused_step_flat.launches, need = 0, 0
        for r in range(rounds):
            batch = {k: torch.from_numpy(v).to(DEV, torch.long)
                     for k, v in loader.round_batch(r, H, S).items()}
            state, met = step(state, batch, root.fold(r))
            # one launch a local step in which any client is active
            need += max(met["ctrl_h_m"].tolist()) if "ctrl_h_m" in met \
                else max(spec.client.local_steps or (H,))
        if fused:
            k1 = su.fused_step_flat.launches
            check(k1 == need, f"{name}: K1 launched {k1} times, the "
                  f"realized H_m need {need}")
        out[fused] = (state, float(met["loss"]))
        del state, met
    (sf, lf), (st, lt) = out[True], out[False]
    worst, n_flips = 0.0, 0
    tree = dict(tree_paths(st))
    for (k, a), (_, c) in zip(tree_paths(sf), tree_paths(st)):
        if not a.is_floating_point():
            check(torch.equal(a, c), f"{name}: {k} differs")
            continue
        head = k.split("/")[0]
        ref_leaf = tree["params/" + k[len(head) + 1:]] \
            if head in ("ef", "buffer") else c
        scale = float(ref_leaf.abs().max()) or 1.0
        diff = (a - c).abs()
        if flips:
            off = int((diff > 1e-5 * scale).sum())
            n_flips += off
            check(off <= max(1, int(1e-4 * diff.numel())),
                  f"{name}: {off} elements of {k} differ beyond 1e-5")
            check(float(diff.max()) <= 2e-4 * scale,
                  f"{name}: {k} differs beyond one int8 quantum")
            diff = torch.where(diff > 1e-5 * scale, 0.0, diff)
        worst = max(worst, float(diff.max()) / scale)
    del out, sf, st, tree
    torch.cuda.empty_cache()
    print(f"[chip_smoke] fused vs tree ({name}, 2 layers, {rounds} rounds): "
          f"loss {lf:.6f} vs {lt:.6f}, worst state diff {worst:.3e} of leaf "
          f"scale" + (f", {n_flips} int8 boundary flips" if flips else "")
          + f"; K1 launches {k1}", flush=True)
    check(abs(lf - lt) <= 1e-5 * abs(lt), f"{name}: fused and tree losses "
          f"differ")
    check(worst <= 1e-5, f"{name}: fused and tree states differ beyond 1e-5")
    return worst, n_flips, k1


def launches_for_hm(log):
    """K1 launches the logged rounds need: max_m H_m a round."""
    return sum(max(rec["ctrl_h_m"]) for rec in log)


def het_phase():
    """8a: per-client H_m from lognormal step times and a depth-2 staleness
    FIFO (polynomial weights), beside the uniform H = 4 round."""
    hm = [int(h) for h in federated.local_steps_from_times(
        federated.sample_step_times("lognormal", 4, seed=0), H_KNOBS)]
    check(len(set(hm)) > 1, f"H_m {hm} is uniform")
    argv = main_argv("savic", 2, ["--h-local", str(H_KNOBS)])
    print("[chip_smoke] 8a uniform H=4: train.main " + " ".join(argv),
          flush=True)
    ulog, _, _, upeak = main_path(argv, 2 * H_KNOBS)
    argv = main_argv("savic", 2, HET_ASYNC)
    print(f"[chip_smoke] 8a heterogeneity + async (H_m {hm}, --het-seed 0):"
          f" train.main " + " ".join(argv), flush=True)
    log, k1, _, peak = main_path(argv, 2 * max(hm))
    check(all(finite(rec["staleness"]) for rec in log), "staleness")
    check(log[1]["staleness"] > 0.0, "the FIFO's second round has no stale "
          "slot")
    print(f"[chip_smoke]   8a round wall {[r['wall_s'] for r in log]} s "
          f"(uniform H=4: {[r['wall_s'] for r in ulog]} s); launches K1 {k1} "
          f"= Σ_r max H_m; peak {peak:.2f} GiB (uniform H=4 {upeak:.2f} GiB)",
          flush=True)
    return {"hm": hm, "walls": [r["wall_s"] for r in log], "peak": peak,
            "uniform_walls": [r["wall_s"] for r in ulog],
            "uniform_peak": upeak, "k1": k1}


def controller_phase():
    """8b: the controller (H_m from the straggler trace, H_t growth, the
    EF-guarded k on topk, b_eff) at full width; the logged observations
    replayed through tests/_reference_controller.py."""
    argv = main_argv("savic", 3, CONTROLLER)
    print("[chip_smoke] 8b controller: train.main " + " ".join(argv),
          flush=True)
    log, k1, _, peak = main_path(argv, launches_for_hm)
    ctrl = train._resolve_spec(train._parser().parse_args(argv), 4)[0] \
        .controller
    s = ref_ctrl.init_ctrl_state(ctrl, 4)
    for rec in log:
        want = (s["h_m"].tolist(), int(s["h_t"]), int(s["b_eff"]),
                round(float(s["k"]), 6))
        got = (rec["ctrl_h_m"], rec["ctrl_h_t"], rec["ctrl_b_eff"],
               rec["ctrl_k"])
        check(got == want, f"round {rec['round']} knobs {got}, oracle "
              f"{want}")
        s, _ = ref_ctrl.controller_step(ctrl, s, {
            "delta_sq_mean": rec["delta_sq_mean"],
            "delta_sq_avg": rec["delta_sq_avg"],
            "payload_sq": rec["payload_sq"],
            "resid_sq": rec["compression_err"]})
        check(rec["ctrl_gns_ema"] == round(float(s["gns_ema"]), 6),
              f"round {rec['round']} gns_ema {rec['ctrl_gns_ema']}")
    print(f"[chip_smoke]   8b knobs replayed by the numpy oracle: H_m "
          f"{[r['ctrl_h_m'] for r in log]}, H_t "
          f"{[r['ctrl_h_t'] for r in log]}, k {[r['ctrl_k'] for r in log]}, "
          f"b_eff {log[0]['ctrl_b_eff']}; launches K1 {k1}; round wall "
          f"{[r['wall_s'] for r in log]} s; peak {peak:.2f} GiB", flush=True)
    return {"log": log, "k1": k1, "peak": peak,
            "walls": [r["wall_s"] for r in log]}


def topk_embed():
    """The controller's topk at the embed.table leaf (4, 137,625,600), k =
    0.1: one ``_compress_leaf`` call (the stable sort), its time and the
    memory it adds above its input."""
    x = torch.randn(EMBED, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(3))
    spec = engine.CompressionSpec(op="topk", k=0.1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: engine._compress_leaf(spec, x, None, k_frac=0.1), 3)
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    c = engine._compress_leaf(spec, x, None, k_frac=0.1)
    kc = engine._kept_count(spec, EMBED[1], 0.1)[0]
    check(bool((torch.count_nonzero(c, dim=1) == kc).all()),
          "topk kept another count")
    del x, c
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   8b topk at the embed.table leaf {EMBED}, k 0.1 "
          f"({kc} kept a row): {ms:.2f} ms a call, {extra:.2f} GiB above its "
          f"input", flush=True)
    return ms, extra


def personal_phase(rounds=2):
    """8c: local-adam with the consistency objective on half-labeled
    sequences and the final norm client-resident, through ``train.setup``
    and its round step; after each round the personal leaf differs across
    clients and every synced leaf is one value."""
    argv = main_argv("local-adam", rounds, SEMI_PERSONAL)
    print("[chip_smoke] 8c objective + personalization: train.setup + "
          "round_step " + " ".join(argv), flush=True)
    su.fused_step_flat.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train.setup(argv)
    state, run.state = run.state, None
    walls = []
    for r in range(rounds):
        batch = train.round_batch(run.loader, run.args, r, DEV)
        check("labeled" in batch, "no labeled leaf")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = run.round_step(state, batch, run.stream(r))
        loss = float(met["loss"])
        walls.append(time.perf_counter() - t0)
        check(finite(loss), f"round {r} loss {loss}")
        for k, p in tree_paths(state["params"]):
            same = bool((p == p[:1]).all())
            if "final_norm" in k:
                check(not same, f"round {r}: personal {k} equal across "
                      f"clients")
            else:
                check(same, f"round {r}: synced {k} differs across clients")
        print(f"[chip_smoke]   round {r} loss {loss:.5f} wall "
              f"{walls[-1]:.4f} s; final_norm/scale differs across clients, "
              f"{len(tree_paths(state['params'])) - 1} synced leaves equal",
              flush=True)
        del batch, met
    k1 = su.fused_step_flat.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(k1 == rounds * H_LOCAL, f"K1 launched {k1} times")
    full = engine.bytes_on_wire(dataclasses.replace(
        run.spec, sync=dataclasses.replace(run.spec.sync, personal=())),
        engine.average_params(state))
    n_pers = state["params"]["final_norm"]["scale"][0].numel()
    check(run.wire["delta_bytes"] == full["delta_bytes"] - 4 * n_pers,
          f"delta bytes {run.wire['delta_bytes']} vs {full['delta_bytes']}")
    del state
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   8c delta bytes {run.wire['delta_bytes']} = "
          f"{full['delta_bytes']} − 4 × {n_pers}; launches K1 {k1}; peak "
          f"{peak:.2f} GiB", flush=True)
    return {"k1": k1, "peak": peak, "walls": walls}


def ptxas_summary(log):
    """One line per kernel of a ``-Xptxas -v`` log: its (mangled) name,
    registers, spill stores and loads, shared memory."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build_all():
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    libs = (su._lib, su._flat_lib, qu._lib, ds._attention_lib,
            ds._sample_lib, fa._lib, ssd._lib)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        list(pool.map(lambda f: f(), libs))
    for src in ("fused_step.cu", "scaled_update.cu", "quantize_update.cu",
                "decode_attention.cu", "decode_sample.cu",
                "flash_attention.cu", "ssd_intra_chunk.cu"):
        info = build.BUILD_LOG.get(src, {"seconds": 0.0, "ptxas": "(cached)"})
        print(f"[chip_smoke] {src}: nvcc {info['seconds']:.2f} s\n"
              f"{info['ptxas']}", flush=True)
    for src in ("decode_attention.cu", "flash_attention.cu",
                "ssd_intra_chunk.cu"):
        for line in ptxas_summary(build.BUILD_LOG.get(src, {}).get("ptxas",
                                                                  "")):
            print(f"[chip_smoke] ptxas {src}: {line}", flush=True)
    print(f"[chip_smoke] built K1, K2, K3, K4, K5, K6 and K7 in "
          f"{time.perf_counter() - t0:.2f} s",
          flush=True)


def main():
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] {smi_line()} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda}", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(0)

    # ---- 1. build ----------------------------------------------------------
    build_all()

    # ---- 2. K1 against its plain version, every engine combination --------
    max_err = 0.0
    for case in K1_CASES:
        for n in (K1_N, K1_N + 1, K1_N - 1):
            err, ulps = compare_case(case, 4, n, gen)
            max_err = max(max_err, err)
            print(f"[chip_smoke] K1 {'-'.join(map(str, case))} n={n}: "
                  f"max abs {err:.3e}, max ulp {ulps}", flush=True)
            check(ulps == 0, f"K1 differs from its plain version ({case})")
    M, n, err, ulps = big_case(gen)
    max_err = max(max_err, err)
    print(f"[chip_smoke] K1 M={M} n={n} (M·n = {M * n} > 2^31): max abs "
          f"{err:.3e}, max ulp {ulps}", flush=True)
    check(ulps == 0, "K1 differs from its plain version beyond 2^31")

    # ---- 2b. K3 against its plain version ----------------------------------
    k3_err = 0.0
    k3_cases = [(M, n, (), False) for M in (1, 4)
                for n in (K1_N, K1_N + 1, K1_N - 1)]
    k3_cases += [(4, K1_N, (0, 2), False), (4, K1_N + 1, (3,), False),
                 (4, K1_N, (), True), (3, K1_N - 1, (1,), True)]
    for M, n, zero_rows, misalign in k3_cases:
        bad, err, ulps = k3_case(M, n, gen, zero_rows, misalign)
        k3_err = max(k3_err, err)
        print(f"[chip_smoke] K3 M={M} n={n} zero rows {list(zero_rows)}"
              f"{' misaligned' if misalign else ''}: q mismatches {bad}, "
              f"dec max abs {err:.3e}, max ulp {ulps}", flush=True)
        check(bad == 0 and ulps == 0, "K3 differs from its plain version")
    for M, n in K3_BIG:
        bad, err, ulps = k3_big(M, n, gen)
        k3_err = max(k3_err, err)
        print(f"[chip_smoke] K3 M={M} n={n} (M·n = {M * n} > 2^31): q "
              f"mismatches {bad}, dec max abs {err:.3e}, max ulp {ulps}",
              flush=True)
        check(bad == 0 and ulps == 0, "K3 differs beyond 2^31")
    (bad, err, ulps), k3_ms, k3_plain_ms, k3_nbytes = k3_embed(gen)
    k3_err = max(k3_err, err)
    k3_bound_ms = k3_nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[chip_smoke] K3 at the embed.table leaf {EMBED}: q mismatches "
          f"{bad}, dec max ulp {ulps}; {k3_ms:.3f} ms/launch, plain "
          f"{k3_plain_ms:.3f} ms, bound {k3_bound_ms:.3f} ms "
          f"({k3_nbytes / 1e9:.3f} GB), achieved "
          f"{k3_nbytes / k3_ms / 1e6:.1f} GB/s", flush=True)
    check(bad == 0 and ulps == 0, "K3 differs at the embed.table shape")

    # ---- 2c. K2 against its plain version ----------------------------------
    k2_err = 0.0
    for n in K2_NS:
        worst = (0.0, 0)
        for squared in (True, False):
            for beta1 in (0.0, 0.9):
                for alpha in (1e-3, 1e-2):
                    err, ulps = k2_case(n, squared, beta1, alpha, gen)
                    worst = (max(worst[0], err), max(worst[1], ulps))
        k2_err = max(k2_err, worst[0])
        print(f"[chip_smoke] K2 n={n}, squared both ways, beta1 0 / 0.9, "
              f"alpha 1e-3 / 1e-2: max abs {worst[0]:.3e}, max ulp "
              f"{worst[1]}", flush=True)
        check(worst[1] == 0, f"K2 differs from its plain version at n={n}")
    x = k2_inputs(K2_NS[-2], gen)
    k2_1m = cuda_ms(lambda: su.scaled_update_flat(*x, **K2_STEP), 200)
    del x
    print(f"[chip_smoke] K2 at n={K2_NS[-2]}: {k2_1m * 1e3:.2f} us/launch, "
          f"bound {24 * K2_NS[-2] / HBM_BYTES_PER_S * 1e6:.2f} us "
          f"({24 * K2_NS[-2]} B)", flush=True)
    for n in (K2_NS[-2], K2_NS[-1]):
        err, ulps = k2_case(n, True, 0.9, 1e-2, gen, misalign=True)
        k2_err = max(k2_err, err)
        print(f"[chip_smoke] K2 n={n} misaligned views (scalar path): max abs"
              f" {err:.3e}, max ulp {ulps}", flush=True)
        check(ulps == 0, "K2 differs from its plain version on misaligned "
              "views")
    for misalign in (False, True):
        n, err, ulps = k2_big(gen, misalign)
        k2_err = max(k2_err, err)
        print(f"[chip_smoke] K2 n={n} (> 2^31, "
              f"{'views one float in, scalar path' if misalign else 'aligned, float4 path with a masked tail'}"
              f"): max abs {err:.3e}, max ulp {ulps} over every element",
              flush=True)
        check(ulps == 0, "K2 differs from its plain version beyond 2^31")

    # ---- 3. main path: savic, full-width qwen2-0.5b ------------------------
    argv = main_argv("savic", 2)
    print("[chip_smoke] main path: train.main " + " ".join(argv), flush=True)
    log, launches, _, peak = main_path(argv, 2 * H_LOCAL)

    params = build_model(get_config("qwen2-0.5b")).init(
        torch.Generator(device=DEV).manual_seed(0))
    n_main = tree_size(params)          # per-client flat length n
    qwen_shapes = {k: tuple(v.shape) for k, v in tree_paths(params)}
    wire = engine.bytes_on_wire(engine.method_spec(
        "savic", compression="int8-stochastic", error_feedback=True), params)
    del params
    torch.cuda.empty_cache()
    main_case = ("adam", "debias", "max", "global", False, 0.0, False, False)
    err, ulps, ms, plain_ms, nbytes = k1_main_shape(main_case, 4, n_main,
                                                    gen, plain_timing=True)
    max_err = max(max_err, err)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[chip_smoke] K1 at the main path's shape (M=4, n={n_main}, "
          f"global D): max abs {err:.3e}, max ulp {ulps}; {ms:.3f} ms/launch, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({nbytes / 1e9:.2f} GB), achieved {nbytes / ms / 1e6:.1f} GB/s",
          flush=True)
    check(ulps == 0, "K1 differs from its plain version at the main shape")

    # ---- 3b. K2 on its path: the per-leaf step ------------------------------
    k2_runs = [k2_path("the Fig. 1 MLP", *MLP_TREE, gen),
               k2_path("the kernels_fused bench's leaves", *BENCH_TREE, gen),
               k2_path("full-width qwen2-0.5b", qwen_shapes, 4, gen)]
    for r in k2_runs:
        print_k2_path(r)
    k2_launches = sum(r["launches"] for r in k2_runs)
    k2_full = k2_runs[-1]
    check(k2_full["n"] == n_main, "the qwen2 tree is not the model's")

    # ---- 4. local-adam: update_d + debias ---------------------------------
    argv = main_argv("local-adam", 1)
    print("[chip_smoke] train.main " + " ".join(argv), flush=True)
    main_path(argv, H_LOCAL)
    la_case = ("adam", "debias", "max", "local", True, 0.0, False, False)
    err, ulps, la_ms, _, la_bytes = k1_main_shape(la_case, 4, n_main, gen,
                                                  plain_timing=False)
    max_err = max(max_err, err)
    print(f"[chip_smoke] K1 local D with update (M=4, n={n_main}): max abs "
          f"{err:.3e}, max ulp {ulps}; {la_ms:.3f} ms/launch, bound "
          f"{la_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, achieved "
          f"{la_bytes / la_ms / 1e6:.1f} GB/s", flush=True)
    check(ulps == 0, "K1 differs from its plain version at the main shape "
          "with local D")

    # ---- 5. compressed path: savic + int8-stochastic + EF -----------------
    argv = main_argv("savic", 2, INT8_EF)
    print("[chip_smoke] compressed path: train.main " + " ".join(argv),
          flush=True)
    clog, _, k3_launches, cpeak = main_path(argv, 2 * H_LOCAL,
                                            2 * N_LEAVES)
    for rec in clog:
        check(finite(rec["compression_err"]) and rec["compression_err"] > 0,
              f"compression_err {rec['compression_err']}")
        check(rec["compression_x"] == wire["compression_x"]
              and rec["delta_bytes"] == wire["delta_bytes"],
              f"records {rec['compression_x']}x / {rec['delta_bytes']} B, "
              f"bytes_on_wire {wire['compression_x']}x / "
              f"{wire['delta_bytes']} B")
        check(rec["wire_bytes"] == [wire["delta_bytes"]] * 4,
              f"measured payload {rec['wire_bytes']} != "
              f"{wire['delta_bytes']} per client")
    print(f"[chip_smoke]   payload {wire['delta_bytes']} B per client "
          f"({wire['compression_x']}x), measured == analytic", flush=True)

    # ---- 6. randomized path: savic + OASIS + participation 0.5 -------------
    argv = main_argv("savic", 2, OASIS_HALF)
    print("[chip_smoke] randomized path: train.main " + " ".join(argv),
          flush=True)
    _, _, _, rpeak = main_path(argv, 2 * H_LOCAL)
    root = rng.TorchStream(0 + 1)              # train.main's --seed 0
    for r in range(2):
        w = engine.participation_weights(engine.SyncSpec(participation=0.5),
                                          root.fold(r), 4, DEV)
        check(sorted(w.tolist()) == [0.0, 0.0, 0.5, 0.5],
              f"round {r} sync weights {w.tolist()}")
        print(f"[chip_smoke]   round {r} sync weights {w.tolist()}",
              flush=True)

    # ---- 7. fused against tree at full width, 2 layers ---------------------
    fused_vs_tree("savic")
    fused_vs_tree("savic int8 + EF", rounds=2, flips=True,
                  compression="int8-stochastic", error_feedback=True)
    fused_vs_tree("savic local OASIS", pc_kind="oasis", scaling="local")

    # ---- 8a-8d. the round's knobs at full width, H = 4 ---------------------
    het = het_phase()
    ctl = controller_phase()
    topk_ms, topk_gib = topk_embed()
    pers = personal_phase()
    _, _, k1_8d_hm = fused_vs_tree(
        "savic H_m (4, 3, 2, 1) + async 2", rounds=2, H=H_KNOBS,
        local_steps=(4, 3, 2, 1), async_buffer=2,
        staleness_weight="polynomial")
    # randk: its kept set comes from the stream, not from the deltas, so no
    # rank at the selection's edge can differ between the two loops
    _, _, k1_8d_ctrl = fused_vs_tree(
        "savic controller + randk EF + async 2", rounds=3, H=H_KNOBS,
        async_buffer=2, compression="randk", compression_k=0.1,
        error_feedback=True, controller=engine.ControllerSpec(
            enabled=True, h_max=H_KNOBS, noise_target=1e-3, buffer_max=2,
            step_times=tuple(federated.sample_step_times("lognormal", 4,
                                                         seed=0))))

    # ---- 7b. the paper's experiments: fig1, thm1 transient, sec52 ---------
    paper_phase()

    # ---- 8. K5 and K6 against their plain versions ------------------------
    k5_err = 0.0
    B, C, Hk, rep, D = K5_MAIN
    k5_cases = [(B, C_, Hk, rep, D, cap, False)
                for C_ in (C, 1, 31, 127, 128, 129, 8192, 32768)
                for cap in (0.0, 30.0)]
    k5_cases += [(*K5_LONG[:4], D, cap, False) for cap in (0.0, 30.0)]
    k5_cases += [(B, C, Hk, rep, D, 0.0, True), (B, 8192, Hk, rep, D, 30.0,
                                                 True),
                 (1, 4099, 1, rep, D, 0.0, False),     # B·Hk = 1
                 (1, 32768, 1, rep, D, 30.0, True),
                 (2, 8224, Hk, rep, 36, 0.0, False),   # scalar loads
                 (2, 300, Hk, 16, D, 30.0, False)]     # rep = RMAX
    for B_, C_, Hk_, rep_, D_, cap, one in k5_cases:
        err, bound = k5_case(B_, C_, Hk_, rep_, D_, cap, gen, one)
        k5_err = max(k5_err, err)
        print(f"[chip_smoke] K5 B={B_} C={C_} Hk={Hk_} rep={rep_} D={D_} "
              f"softcap={cap} plan {ds.attention_plan(B_, Hk_, C_)}"
              f"{' all but one masked' if one else ''}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, "K5 differs from its plain version")
    # one valid position, at the start, middle and end of every split (all
    # other splits wholly masked), at both path shapes and around whole
    # splits (C one short and one past)
    for B_, C_, Hk_ in ((B, C, Hk), (*K5_LONG[:2], Hk), (B, 3 * 64 - 1, Hk),
                        (B, 3 * 64 + 1, Hk)):
        split, splits = ds.attention_plan(B_, Hk_, C_)
        worst, least = 0.0, float("inf")     # largest error, smallest bound
        for sp in range(splits):
            for at in sorted({sp * split, min(C_ - 1, sp * split + split // 2),
                              min(C_ - 1, (sp + 1) * split - 1)}):
                err, bound = k5_case(B_, C_, Hk_, rep, D, 30.0 * (sp % 2),
                                     gen, at=at)
                check(err <= bound, f"K5 differs from its plain version with "
                      f"one valid position at {at} (C={C_})")
                worst, least = max(worst, err), min(least, bound)
        k5_err = max(k5_err, worst)
        print(f"[chip_smoke] K5 B={B_} C={C_}: one valid position at the "
              f"start, middle and end of each of {splits} splits of {split}: "
              f"max abs {worst:.3e} (smallest bound {least:.1e})", flush=True)
    torch.cuda.empty_cache()
    k6_ties, k6_err = 0, 0.0
    k6_cases = [(B_, greedy, None, False) for B_ in (1, 8, 32)
                for greedy in (True, False)]
    k6_cases += [(8, True, (100, 101), False), (8, True, (100, 90000), False),
                 (8, False, None, True)]
    for B_, greedy, dup, pad in k6_cases:
        ties, bad, err = k6_case(B_, greedy, gen, dup, pad)
        k6_ties += ties
        k6_err = max(k6_err, err)
        print(f"[chip_smoke] K6 B={B_} V={V_PAD} v_real={V_REAL} "
              f"{'greedy' if greedy else 'gumbel'}"
              f"{f' duplicated rows {dup}' if dup else ''}"
              f"{' masked padded winner' if pad else ''}: near-tie "
              f"exceptions {ties}, violations {bad}, winning logit max abs "
              f"{err:.3e}", flush=True)
        check(bad == 0, "K6 breaks the near-tie rule against its plain "
              "version")
    torch.cuda.empty_cache()

    # ---- 8b. K4 against its plain version ----------------------------------
    k4_err = 0.0
    for B_, S_, H_, Hk_, D_, win, cap, dt in K4_CASES:
        err, bound = k4_case(B_, S_, H_, Hk_, D_, win, cap, dt, gen)
        if dt == torch.float32:
            k4_err = max(k4_err, err)
        print(f"[chip_smoke] K4 B={B_} S={S_} H={H_} Hk={Hk_} D={D_} "
              f"window={win} softcap={cap} {str(dt)[6:]}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, "K4 differs from its plain version")

    # ---- 9. serving main path: prefill reuse + 63 decode steps -------------
    print("[chip_smoke] serve main path: serve('qwen2-0.5b', reduced=False, "
          f"use_decode_kernel=True, {SERVE})", flush=True)
    _, k5_launches, k6_launches, speak = serve_main_path()
    cfg_full, sparams = serve_params()
    ties, n_ids = teacher_forced(cfg_full, sparams)
    print(f"[chip_smoke] kernel vs plain decode, teacher-forced, full width: "
          f"{n_ids} ids, near-tie exceptions {ties}", flush=True)

    # ---- 10. continuous batching at full width -----------------------------
    print(f"[chip_smoke] serve_continuous('qwen2-0.5b', reduced=False, "
          f"use_decode_kernel=True, {TRACE})", flush=True)
    _, _, _, cties, ccompared = continuous_path(cfg_full, sparams)
    print(f"[chip_smoke]   ring tokens vs solo serving (requests 0, 7, 15, "
          f"teacher-forced): {ccompared} ids, near-tie exceptions {cties}",
          flush=True)
    # ---- 10b. long-prompt serve: K4 prefill, K5/K6 decode at C = 8224 -----
    print("[chip_smoke] long-prompt serve path: serve('qwen2-0.5b', "
          f"reduced=False, use_flash_kernel=True, use_decode_kernel=True, "
          f"{LONG})", flush=True)
    _, k4_launches, _, _, lpeak = long_serve_path()
    lerr, lbound, cerr, cratio, lties, l_ids = long_teacher_forced(cfg_full,
                                                                   sparams)
    print(f"[chip_smoke] K4 path vs chunked plain path, teacher-forced, "
          f"full width, prompt {LONG['prompt_len']}: last logits max abs "
          f"{lerr:.3e} (bound {lbound:.3e}), caches max abs {cerr:.3e} "
          f"(worst layer at {cratio:.3f} of its bound), {l_ids} ids, "
          f"near-tie exceptions {lties}", flush=True)
    del sparams
    torch.cuda.empty_cache()

    # ---- 12. K7 against its plain version ----------------------------------
    k7_err = 0.0
    for B_, S_, H_, P_, N_, Q_, a_, shared in K7_CASES:
        err, ratio, eps, cmax, groups = k7_case(B_, S_, H_, P_, N_, Q_, a_,
                                                shared, gen)
        k7_err = max(k7_err, err)
        stride0 = {True: " B/C head stride 0", "B": " B head stride 0, C "
                   "per head", False: ""}[shared]
        print(f"[chip_smoke] K7 B={B_} S={S_} H={H_} P={P_} N={N_} Q={Q_} "
              f"A={'-linspace(1, 16)' if a_ is None else a_}{stride0} "
              f"({groups} G group{'s' if groups > 1 else ''}): max abs "
              f"{err:.3e}, worst error at {ratio:.3f} of its bound (bound "
              f"{eps:.2e} of the magnitude sum, max|cum| {cmax:.1f}); a "
              f"second call bitwise the first", flush=True)
        check(ratio <= 1.0, "K7 differs from its plain version")

    # ---- 12b. K6 against its plain version at mamba2's head ----------------
    for B_, greedy in ((MAMBA["batch"], True), (MAMBA["batch"], False),
                       (MTRACE["slots"], True)):
        ties, bad, err = k6_case(B_, greedy, gen, head=MAMBA_HEAD)
        print(f"[chip_smoke] K6 B={B_} V={MAMBA_HEAD[0]} v_real="
              f"{MAMBA_HEAD[1]} d={MAMBA_HEAD[2]} "
              f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions "
              f"{ties}, violations {bad}, winning logit max abs {err:.3e}",
              flush=True)
        check(bad == 0, "K6 breaks the near-tie rule at mamba2's head")
    torch.cuda.empty_cache()

    # ---- 12c. K6 at heads wider than 2048 (y staged in slices over d) -----
    for name, head in WIDE_HEADS.items():
        worst = (0, 0, 0.0)
        for B_ in (1, 4, 8):
            for greedy in (True, False):
                ties, bad, err = k6_case(B_, greedy, gen, head=head)
                worst = (worst[0] + ties, worst[1] + bad, max(worst[2], err))
        k6_err = max(k6_err, worst[2])
        print(f"[chip_smoke] K6 {name} head (V={head[0]}, v_real={head[1]}, "
              f"d={head[2]}, slices of "
              f"{ds.sample_plan(8, head[2], head[1])[2]} at B=8), B 1/4/8, "
              f"greedy and gumbel: near-tie exceptions {worst[0]}, "
              f"violations {worst[1]}, winning logit max abs "
              f"{worst[2]:.3e}", flush=True)
        check(worst[1] == 0, f"K6 breaks the near-tie rule at {name}'s head")
    torch.cuda.empty_cache()

    # ---- 13. mamba2-1.3b serve: K7 prefill, K6 decode ----------------------
    print("[chip_smoke] mamba2 serve path: serve('mamba2-1.3b', "
          f"reduced=False, use_ssd_kernel=True, use_decode_kernel=True, "
          f"{MAMBA})", flush=True)
    _, k7_launches, _, mpeak = mamba_serve_path()
    mcfg, mparams = mamba_params()
    lerr, lbound, cratio, mties, m_ids, cmax = mamba_teacher_forced(mcfg,
                                                                    mparams)
    print(f"[chip_smoke] K7 route vs ssd_chunked route, teacher-forced, full "
          f"width, prompt {MAMBA['prompt_len']}: last logits max abs "
          f"{lerr:.3e} (bound {lbound:.3e}, max|cum| {cmax:.1f}), cache "
          f"leaves at {cratio:.3f} of their bounds at worst, {m_ids} ids, "
          f"near-tie exceptions {mties}", flush=True)

    # ---- 13b. mamba2 continuous batching at full width ---------------------
    print(f"[chip_smoke] serve_continuous('mamba2-1.3b', reduced=False, "
          f"use_ssd_kernel=True, use_decode_kernel=True, {MTRACE})",
          flush=True)
    _, _, _, mcties, mcompared = mamba_continuous(mcfg, mparams)
    print(f"[chip_smoke]   ring tokens vs solo serving (requests 0, 7, 15, "
          f"teacher-forced): {mcompared} ids, near-tie exceptions {mcties}",
          flush=True)
    del mparams
    torch.cuda.empty_cache()

    # ---- 14. K4, K5, K6 and K7 timed at the serve paths' shapes ------------
    k5t, k5lt, k6t = (time_k5(K5_MAIN, gen, K5_MAIN_SPLITS),
                      time_k5(K5_LONG, gen, K5_LONG_SPLITS), time_k6(gen))
    for label, t in (("K5", k5t), (f"K5 at C={K5_LONG[1]}", k5lt)):
        alts = ", ".join(f"{sp}{' (plan)' if sp == t['plan'] else ''}: "
                         f"{a * 1e3:.2f} / {b * 1e3:.2f} us"
                         for sp, (a, b) in t["split_ms"].items())
        print(f"[chip_smoke] {label} at the serve path's shape: "
              f"{t['ms'] * 1e3:.2f} us/call back to back (2 launches), "
              f"plain {t['plain_ms'] * 1e3:.2f} us, library "
              f"{t['library_ms'] * 1e3:.2f} us; device time (CUDA graph of "
              f"50 calls) {t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_device_ms'] * 1e3:.2f} us, library "
              f"{t['library_device_ms'] * 1e3:.2f} us; bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B); by split "
              f"length, back to back / device: {alts}", flush=True)
    print(f"[chip_smoke] K6 at the serve path's shape: "
          f"{k6t['ms'] * 1e3:.2f} us/call, plain {k6t['plain_ms'] * 1e3:.2f} "
          f"us, library {k6t['library_ms'] * 1e3:.2f} us, bound "
          f"{k6t['bound_ms'] * 1e3:.3f} us ({k6t['bytes']} B)", flush=True)
    k6m = time_k6(gen, MAMBA["batch"], MAMBA_HEAD)
    print(f"[chip_smoke] K6 at mamba2's head (B={MAMBA['batch']}, "
          f"V={MAMBA_HEAD[0]}, v_real={MAMBA_HEAD[1]}, d={MAMBA_HEAD[2]}): "
          f"{k6m['ms'] * 1e3:.2f} us/call, plain {k6m['plain_ms'] * 1e3:.2f} "
          f"us, library {k6m['library_ms'] * 1e3:.2f} us, bound "
          f"{k6m['bound_ms'] * 1e3:.3f} us ({k6m['bytes']} B)", flush=True)
    for name in ("gemma3-4b", "deepseek-67b"):
        head = WIDE_HEADS[name]
        k6w = time_k6(gen, 8, head)
        print(f"[chip_smoke] K6 at {name}'s head (B=8, V={head[0]}, "
              f"v_real={head[1]}, d={head[2]}): {k6w['ms'] * 1e3:.2f} us/call,"
              f" plain {k6w['plain_ms'] * 1e3:.2f} us, library "
              f"{k6w['library_ms'] * 1e3:.2f} us, bound "
              f"{k6w['bound_ms'] * 1e3:.3f} us ({k6w['bytes']} B)",
              flush=True)
    k7t, k7o = time_k7(gen), time_k7(gen, K7_ONE)
    for label, shape, t in (("the prefill's", K7_MAIN, k7t),
                            ("the continuous-batching prefill's", K7_ONE,
                             k7o)):
        print(f"[chip_smoke] K7 at {label} shape {shape}: "
              f"{t['ms'] * 1e3:.2f} us/call back to back (2 launches), "
              f"device time (CUDA graph) {t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, whole plain SSD (ssd_chunked) "
              f"{t['chunked_ms'] * 1e3:.2f} us, whole K7 route (ops.ssd) "
              f"{t['route_ms'] * 1e3:.2f} us, library none, bound "
              f"{t['bound_ms'] * 1e3:.3f} us (operations: "
              f"{t['flops'] / 1e9:.3f} GFLOP, {t['groups']} G group(s); "
              f"bytes {t['bytes'] / 1e6:.1f} MB), achieved "
              f"{t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s, "
              f"{t['bound_ms'] / t['ms'] * 100:.1f} % of the bound "
              f"({t['bound_ms'] / t['device_ms'] * 100:.1f} % on device "
              f"time)", flush=True)
    k4t = time_k4(gen)
    print(f"[chip_smoke] K4 at the prefill's shape {K4_MAIN}: "
          f"{k4t['ms']:.3f} ms/launch, plain {k4t['plain_ms']:.3f} ms, "
          f"chunked models/flash.py {k4t['chunked_ms']:.3f} ms, SDPA "
          f"{k4t['library_ms']:.3f} ms, bound {k4t['bound_ms']:.3f} ms "
          f"(operations: {k4t['flops'] / 1e9:.1f} GFLOP; bytes "
          f"{k4t['bytes'] / 1e6:.1f} MB), achieved "
          f"{k4t['flops'] / k4t['ms'] / 1e9:.2f} TFLOP/s; clocks "
          f"max/now (MHz) {smi_line('clocks.max.sm,clocks.sm')}",
          flush=True)

    kernels = [{
        "name": "fused_step_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_step.cu",
        "replaces": "src/repro/kernels/scaled_update.py:201",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "scaled_update_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scaled_update.cu",
        "replaces": "src/repro/kernels/scaled_update.py:103",
        "launches": k2_launches, "max_abs_err": k2_err,
        "ms": k2_full["ms"], "plain_ms": k2_full["plain_ms"],
        "bound_ms": k2_full["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "quantize_update_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_update.cu",
        "replaces": "src/repro/kernels/quantize_update.py:56",
        "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
        "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
        "bound_by": "bytes", "library_ms": None,
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_step.py:71",
        "launches": k5_launches, "max_abs_err": k5_err, "ms": k5t["ms"],
        "plain_ms": k5t["plain_ms"], "bound_ms": k5t["bound_ms"],
        "bound_by": "bytes", "library_ms": k5t["library_ms"],
        "device_ms": k5t["device_ms"],
    }, {
        "name": "decode_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_sample.cu",
        "replaces": "src/repro/kernels/decode_step.py:133",
        "launches": k6_launches, "max_abs_err": k6_err, "ms": k6t["ms"],
        "plain_ms": k6t["plain_ms"], "bound_ms": k6t["bound_ms"],
        "bound_by": "bytes", "library_ms": k6t["library_ms"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:76",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": k4t["ms"],
        "plain_ms": k4t["plain_ms"], "bound_ms": k4t["bound_ms"],
        "bound_by": "operations", "library_ms": k4t["library_ms"],
    }, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:52",
        "launches": k7_launches, "max_abs_err": k7_err, "ms": k7t["ms"],
        "plain_ms": k7t["plain_ms"], "bound_ms": k7t["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "device_ms": k7t["device_ms"],
    }]
    print(f"[chip_smoke] peak memory: savic {peak:.2f} GiB, savic int8 + EF "
          f"{cpeak:.2f} GiB, savic OASIS + participation 0.5 {rpeak:.2f} GiB, "
          f"serve {speak:.2f} GiB, long-prompt serve {lpeak:.2f} GiB, "
          f"mamba2 serve {mpeak:.2f} GiB; 8a H_m + async {het['peak']:.2f} "
          f"GiB (uniform H=4 {het['uniform_peak']:.2f}), 8b controller "
          f"{ctl['peak']:.2f} GiB (topk at embed.table {topk_ms:.2f} ms, "
          f"+{topk_gib:.2f} GiB), 8c objective + personal "
          f"{pers['peak']:.2f} GiB", flush=True)
    print(f"[chip_smoke] K1 launches on the knob paths: 8a {het['k1']}, 8b "
          f"{ctl['k1']}, 8c {pers['k1']}, 8d {k1_8d_hm} (H_m) and "
          f"{k1_8d_ctrl} (controller)", flush=True)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
