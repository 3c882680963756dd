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
``models.ssm.ssd_chunked``), and checks what comes out. Phase 9 holds
checkpoint and resume through ``train.main --ckpt``: full-width savic
through K1, 3 rounds against 2 + restore + 1 (9a); two full-width 2-layer
cases with every optional state group between them, 4 rounds against
2 + 2 (9b, K3 in one); the final checkpoints byte for byte equal, save and
restore times and the host's memory printed; then ``launch/train_lm.py``'s
six methods and full-width savic (9c). It writes its checkpoints under
``.chip_smoke_ckpt/`` beside this file and removes the directory. Phase
10 drives the hybrid and qwen3-4b at full width and depth: zamba2-2.7b
served at batch 4 from a 2048-token prompt through K7 (its 54 mamba
layers), K4 (the 9 applications of its weight-tied attention block, d_head
80), K5 and K6, its prefill's device time split by kernel, the kernel
prefill held against the plain one and the K5/K6 decode against the plain
decode (10a); continuous batching of 16 requests on 8 slots, three held
against solo serving (10b); qwen3-4b served at batch 8 from a 512-token
prompt through K4, K5 and K6, held the same way (10c); savic on zamba2 cut
to 12 layers through ``train.main`` on K1, and fused against tree at 6
(10d); then K4-K7 against their plain versions and timed at these
shapes. Phase 11 drives gemma3-4b at full width and depth: served at
batch 2 from a 4096-token prompt through K4 at d_head 256 (its 34 layers:
29 with the 1024 window, 5 global), K5 (the window in each local layer's
bias) and K6 on the tied table (11a), the K4 prefill held against the
chunked plain one with the same per-layer windows and the K5/K6 decode
against the plain decode (11b), then K4 (global and windowed), K5 and K6
against their plain versions at its shapes and timed, SDPA beside K4 and
K5 with the backend it took (11c). Phase 12 drives qwen2-moe-a2.7b at full
width and depth (24 layers of 60 routed top-4 experts and a shared MLP;
53.33 GiB of fp32 weights): served at batch 4 from a 2048-token prompt
through K4, K5 and K6, each prompt row routed at capacity 176 with the
overflow dropped, its prefill's device time split by kernel and the
share of choices dropped per layer printed (12a); K4 held layer by layer
(the plain route's input to each layer through both routes) and the K4
prefill end to end, the K5/K6 decode teacher-forced, every layer's routing
recorded on both routes and every difference held as a near tie (12b);
continuous batching of 16 requests on 8 slots, three held against solo
serving (12c); K4, K5 and K6 against their plain versions at its shapes and
timed (12d). It starts by checking that the earlier phases left under 1
GiB allocated, and holds one full-width copy of the weights at a time.
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
import contextlib
import dataclasses
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch import checkpoint as ckpt_lib  # noqa: E402
from repro_torch import configs  # noqa: E402
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
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.models import (ModelCallConfig, sample_batch,  # noqa: E402
                                sample_ids)
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.flash import flash_attention_bshd  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.utils import rng  # noqa: E402
from repro_torch.utils.flatten import FlatLayout  # noqa: E402
from repro_torch.utils.tree import tree_map, tree_paths, tree_size  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# the controller's numpy oracle (numpy only) and the MoE routing records
# (torch only), beside the tests
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _reference_controller as ref_ctrl  # noqa: E402
from _torch_moe_routing import RouteRecorder, hold_routing  # noqa: E402

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
            (1, 4097, 14, 2, 64, 0, 0.0, torch.bfloat16),
            # D = 256 (gemma3's 256-thread, 32-key-tile instance): S not a
            # multiple of the tile, its window with softcap, bf16, and a D
            # of 160 that pads to 256
            (1, 4097, 8, 4, 256, 0, 0.0, torch.float32),
            (1, 2049, 8, 4, 256, 1024, 30.0, torch.float32),
            (1, 2049, 8, 4, 256, 0, 0.0, torch.bfloat16),
            (2, 2048, 8, 4, 160, 300, 0.0, torch.float32)]
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
# phase 10: the hybrid zamba2-2.7b (54 mamba2 layers, one weight-tied
# attention + MLP block after every 6th: 9 applications, d_head 80, 32 kv
# heads) and qwen3-4b (36 layers, GQA 32/8, d_head 128, qk-norm) at full
# width and depth
ZAMBA = dict(batch=4, prompt_len=2048, gen_len=64)
N_ZAMBA_LAYERS, N_ZAMBA_APPS = 54, 9
ZTRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
              arrival_rate=0.5, seed=0)
QWEN3 = dict(batch=8, prompt_len=512, gen_len=64)
N_QWEN3_LAYERS = 36
K4_ZAMBA = (4, 2048, 32, 32, 80)        # B, S, H, Hk, D: the shared block's
K4_QWEN3 = (8, 512, 32, 8, 128)
K5_ZAMBA = (4, 2112, 32, 1, 80)         # B, C, Hk, rep, D of the decode
K5_QWEN3 = (8, 576, 8, 4, 128)
K7_ZAMBA = (4, 2048, 80, 64, 64, 256)   # B, S, H, P, N, Q of the prefill
K7_ZAMBA_ONE = (1, 256, 80, 64, 64, 256)
# phase 11: gemma3-4b (34 layers: 29 local with a sliding window of 1024, 5
# global at 5, 11, 17, 23, 29; GQA 8/4 at d_head 256, qk-norm, GeGLU; a
# tied 262,144-row head scaled by 2560^-1/2) at full width and depth; its
# 4096-token prompt makes the window mask three quarters of a late row's
# keys, in the prefill and in every decode step
GEMMA = dict(batch=2, prompt_len=4096, gen_len=64)
N_GEMMA_LAYERS, GEMMA_GLOBAL, GEMMA_WINDOW = 34, (5, 11, 17, 23, 29), 1024
K4_GEMMA = (2, 4096, 8, 4, 256)         # B, S, H, Hk, D of the prefill's K4
K5_GEMMA = (2, 4160, 4, 2, 256)         # B, C, Hk, rep, D of the decode
# phase 12: qwen2-moe-a2.7b (24 layers, d 2048, MHA 16/16 of d_head 128 with
# QKV bias; 60 routed experts of width 1408, top 4, and a 5632-wide shared
# MLP in every layer; capacity factor 1.25; an untied 151,936-row head) at
# full width and depth: 14,315,587,584 parameters, 53.33 GiB in fp32
MOE_ARCH = "qwen2-moe-a2.7b"
MOE = dict(batch=4, prompt_len=2048, gen_len=64)
N_MOE_LAYERS = 24
MOE_TRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
                 arrival_rate=0.5, seed=0)
K4_MOE = (4, 2048, 16, 16, 128)         # B, S, H, Hk, D of the prefill's K4
K5_MOE = (4, 2112, 16, 1, 128)          # B, C, Hk, rep, D of the decode
K5_MOE_RING = (8, 320, 16, 1, 128)      # the continuous ring's decode
MOE_HEAD = (153_600, 151_936, 2048, 2048 ** -0.5, 1.0)
# a token's first routing difference between two routes must have a top-K
# margin within this many times the largest router-probability difference
# of the tokens whose routing agreed (tests/_torch_moe_routing.py)
MOE_FLIP_FACTOR = 4.0
# 10d: zamba2 training at full width, depth cut to 12 layers (two
# applications of the shared block; below 6 it would never run) and to 6
# for fused against tree (one application)
ARCH_Z12 = "zamba2-2.7b-12l"
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


def k5_inputs(B, C, Hk, rep, D, gen, one_valid=False, window=0):
    """q fp32, k/v bf16 cache, and a causal bias at a random position per
    row (``one_valid``: every position but that one masked; ``window``: and
    every position ``window`` or more before it, as a local layer's)."""
    q = torch.randn((B, Hk * rep, D), generator=gen, device=DEV)
    k = torch.randn((B, C, Hk, D), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, C, Hk, D), generator=gen, device=DEV).bfloat16()
    pos = torch.randint(0, C, (B,), generator=gen, device=DEV)
    idx = torch.arange(C, device=DEV)
    ok = idx[None] == pos[:, None] if one_valid else idx[None] <= pos[:, None]
    if window:
        ok &= pos[:, None] - idx[None] < window
    return q, k, v, torch.where(ok, 0.0, -1e30).float().contiguous()


def k5_case(B, C, Hk, rep, D, cap, gen, one_valid=False, at=None,
            window=0):
    """(max abs error, its bound 1e-5·max|v|) of K5 against its plain
    version. ``at``: every position but ``at`` masked in every row."""
    q, k, v, bias = k5_inputs(B, C, Hk, rep, D, gen, one_valid, window)
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


def sdpa_backend(fn, calls=3):
    """(backend, name of its longest CUDA kernel) of ``calls`` traced calls
    of ``fn``, an SDPA call: "flash", "efficient" (the memory-efficient
    kernel), "cudnn" or "math" (GEMMs and a softmax), by that name; "not
    traced" where the profiler recorded no kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted(profile_serve._device_events(prof),
                 key=lambda e: -e.self_device_time_total)
    names = " ".join(e.key.lower() for e in evs)
    del prof
    if not evs:
        return "not traced", ""
    kind = ("cudnn" if "cudnn" in names else "flash" if "flash" in names
            else "efficient" if "fmha" in names or "efficient" in names
            else "math")
    return kind, evs[0].key[:70]


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
    k5["library_backend"] = sdpa_backend(fns["library_"][0])
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


def k4_work(B, S, H, Hk, D, window=0):
    """(flops, bytes) K4 must do at a causal shape: two D-long dots per
    pair that the causal mask (and ``window``, where positive) keeps; read
    q, k, v once, write out."""
    w = window if window and window < S else S
    pairs = B * H * (w * (w + 1) // 2 + (S - w) * w)
    return 4 * D * pairs, 4 * (2 * B * S * H * D + 2 * B * S * Hk * D)


def time_k4(gen, shape=K4_MAIN, window=0):
    """K4 at a prefill's shape (with ``window`` where positive): CUDA-event
    times of the kernel wrapper, its plain version (row by row), the
    port's chunked ``models/flash.py`` forward (KV repeated to H heads
    beforehand, blocks of 1024, as the model's plain route runs it) and
    SDPA (fp32, GQA; causal, or a boolean mask of the window) with the
    backend it took, and its bound, counted on the true D (a D of 80 pads
    to the 128-wide tile) and the pairs the mask keeps."""
    B, S, H, Hk, D = shape
    q, k, v = k4_inputs(B, S, H, Hk, D, torch.float32, gen)
    out = fa.flash_attention(q, k, v, window=window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    i = torch.arange(S, device=DEV)
    mask = (i[None] <= i[:, None]) & (i[:, None] - i[None] < window) \
        if window else None

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    lib = sdpa().transpose(1, 2)
    err = float((lib - out).abs().max())
    check(err <= 1e-4 * float(v.abs().max()),
          f"SDPA does not compute K4's function ({err:.3e})")
    del lib, out
    torch.cuda.empty_cache()
    kern = lambda: fa.flash_attention(q, k, v, window=window)
    t = {"ms": cuda_ms(kern, 10),
         "device_ms": graph_ms(kern, calls=5, replays=4),
         "plain_ms": cuda_ms(lambda: k4_plain(q, k, v, window), 2),
         "library_ms": cuda_ms(sdpa, 5),
         "library_backend": sdpa_backend(sdpa)}
    pos = torch.arange(S, device=DEV)
    kr, vr = (torch.repeat_interleave(x, H // Hk, dim=2) for x in (k, v))
    with torch.no_grad():
        t["chunked_ms"] = cuda_ms(lambda: flash_attention_bshd(
            q, kr, vr, pos, pos, window=window or None, bq=1024, bk=1024),
            2)
    t["flops"], t["bytes"] = k4_work(B, S, H, Hk, D, window)
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["flops"] / FP32_FLOP_PER_S) * 1e3
    del q, k, v, qt, kt, vt, kr, vr, mask
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


def reset_counts():
    for fn in (fa.flash_attention, ds.decode_attention, ds.decode_sample,
               ssd.ssd_intra_chunk, su.fused_step_flat):
        fn.launches = 0


def read_counts():
    return {"k4": fa.flash_attention.launches,
            "k5": ds.decode_attention.launches,
            "k6": ds.decode_sample.launches,
            "k7": ssd.ssd_intra_chunk.launches}


def full_params(arch):
    """The weights ``serve`` makes for seed 0 at ``arch``'s full width."""
    cfg = get_config(arch)
    return cfg, build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(0))


def serve_path(arch, kw, want, **flags):
    """``serve`` of ``arch`` at full width and depth with the kernel
    ``flags``, counts set to 0 just before and read just after; checks the
    counts against ``want`` and the ids against the real vocabulary.
    Returns (result, counts, peak GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve_mod.serve(arch, reduced=False, device="cuda", verbose=False,
                          **flags, **kw)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = kw["gen_len"] - 1
    t = res.timings
    print(f"[chip_smoke]   TTFT (prefill, B={kw['batch']}, S="
          f"{kw['prompt_len']}) {t['prefill_s'] * 1e3:.3f} ms; decode "
          f"{steps} steps {t['decode_s']:.4f} s, median step "
          f"{float(np.median(res.per_token_s)) * 1e3:.3f} ms; "
          f"{t['tok_per_s']:.2f} tokens/s; peak memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    v_real = get_config(arch).vocab_size
    check(res.tokens.shape == (kw["batch"], kw["gen_len"]),
          f"{arch} tokens {res.tokens.shape}")
    check(0 <= int(res.tokens.min()) and int(res.tokens.max()) < v_real,
          f"{arch}: an id outside the real vocabulary")
    check(counts == want, f"{arch} launches {counts}, expected {want}")
    return res, counts, peak


def continuous_check(arch, params, trace, flags, solo_flags,
                     prefill_calls, k5_calls):
    """``serve_continuous`` of ``arch`` at full width with the kernel
    ``flags`` on the weights ``params``, counts set to 0 just before and
    read just after, and held: ``prefill_calls`` ({kernel: calls}) for each
    admitted request, ``k5_calls`` K5 calls and one K6 launch a decode step.
    Then three of its requests held against solo serving (``solo_flags``),
    teacher-forced on the ring's tokens under the near-tie rule (a B=1
    decode runs other cuBLAS kernels than the ring's B=8 one); each
    admission's B=1 prefill cache tree went into its slot through
    ``insert_slot``. Returns (result, counts, exceptions, ids compared)."""
    cfg = get_config(arch)
    reset_counts()
    res = serve_mod.serve_continuous(arch, reduced=False, device="cuda",
                                     verbose=False, params=params, **flags,
                                     **trace)
    counts = read_counts()
    m = res.metrics
    n = trace["n_requests"]
    print(f"[chip_smoke]   {m['n_requests']} requests / {m['slots']} slots: "
          f"{m['total_tokens']} tokens in {m['makespan_steps']} steps "
          f"({m['tok_per_step']:.3f} tokens/step), {m['decode_steps']} "
          f"decode steps, p50 step {m['p50_step_s'] * 1e3:.3f} ms, p99 "
          f"{m['p99_step_s'] * 1e3:.3f} ms, wall {m['wall_s']:.3f} s "
          f"({m['wall_tok_per_s']:.1f} tokens/s), prefill "
          f"{m['prefill_s']:.3f} s, mean queue delay "
          f"{m['mean_queue_delay_steps']:.3f} steps; launches {counts}",
          flush=True)
    check(all(rq["finish"] is not None for rq in res.requests.values()),
          f"{arch}: a request did not finish")
    _, gens = serve_mod.poisson_trace(n, trace["arrival_rate"], trace["seed"],
                                      trace["gen_len"])
    check([len(res.tokens[r]) for r in range(n)] == [int(g) for g in gens],
          f"{arch}: a request got the wrong token count")
    steps = m["decode_steps"]
    want = {"k4": 0, "k7": 0, **{k: c * n for k, c in prefill_calls.items()},
            "k5": K5_PER_CALL * k5_calls * steps, "k6": steps}
    check(counts == want, f"{arch} continuous launches {counts}, expected "
          f"{want}")
    check(all(int(t.max()) < cfg.vocab_size for t in res.tokens.values()),
          f"{arch}: an id outside the real vocabulary")
    S, G = trace["prompt_len"], trace["gen_len"]
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            **solo_flags))
    ties = compared = 0
    with torch.inference_mode():
        for r in (0, 7, 15):
            ring = torch.from_numpy(res.tokens[r]).to(DEV)
            prompt = serve_mod.request_prompt(cfg, trace["seed"], r, S, DEV)
            logits, cache = kern.prefill_cache(params, prompt, S + G)
            first = sample_ids(logits, 0.0, cfg.vocab_size)
            check(int(first[0]) == int(ring[0]),
                  f"{arch} request {r}: first token differs from solo")
            for g in range(1, len(ring)):
                lg, cache = kern.decode(params, cache, ring[g - 1:g],
                                        S + g - 1)
                want_id = sample_ids(lg, 0.0, cfg.vocab_size)
                t, bad = ref.near_tie_check(lg, ring[g:g + 1], want_id,
                                            cfg.vocab_size)
                check(bad == 0, f"{arch} request {r} step {g}: ring token "
                      f"breaks the near-tie rule against solo serving")
                ties += t
                compared += 1
    print(f"[chip_smoke]   ring tokens vs solo serving (requests 0, 7, 15, "
          f"teacher-forced): {compared} ids, near-tie exceptions {ties}",
          flush=True)
    return res, counts, ties, compared


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


# --------------------------------------------------------------------------- #
# phase 10: the hybrid (zamba2-2.7b) and qwen3-4b at full width
# --------------------------------------------------------------------------- #


def prefill_profile(cfg, params, kw, **flags):
    """Device time of one kernel-route prefill at ``kw``'s shape, split by
    ``profile_serve.prefill_breakdown`` (K4, K7, GEMMs, the rest)."""
    model = build_model(cfg, ModelCallConfig(dtype=torch.float32, **flags))
    B, S = kw["batch"], kw["prompt_len"]
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        model.prefill_cache(params, prompt, S + kw["gen_len"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill_cache(params, prompt, S + kw["gen_len"])
            torch.cuda.synchronize()
    out = profile_serve.prefill_breakdown(prof)
    top = out["prefill_top_kernels"][:5]
    del prof
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   {cfg.name} prefill device time "
          f"{out['prefill_device_ms']:.2f} ms: K7 "
          f"{out['prefill_k7_ms']:.2f} ms ({out['prefill_k7_launches']} "
          f"launches), K4 {out['prefill_k4_ms']:.2f} ms "
          f"({out['prefill_k4_launches']}), GEMMs "
          f"{out['prefill_gemm_ms']:.2f} ms, rest "
          f"{out['prefill_other_ms']:.2f} ms; top "
          f"{[(e['name'][:40], round(e['ms'], 2)) for e in top]}",
          flush=True)
    return out


def decode_same_cache(cfg, params, cache, tok, S, G, kern, plain, what):
    """K5/K6 decode against the plain decode, each from its own clone of
    one prefill cache, teacher-forced on the plain route's greedy tokens;
    ids under the near-tie rule. Returns (exceptions, ids compared)."""
    clone = lambda c: tree_map(lambda t: t.clone(), c)
    cache_p, cache_k = clone(cache), clone(cache)
    head = kern.sample_head(params)
    ties = 0
    with torch.inference_mode():
        for g in range(G - 1):
            lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            zeros = torch.zeros_like(lg)
            ids, cache_k = kern.decode_sample(params, cache_k, tok, S + g,
                                              zeros, head)
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            t, bad = ref.near_tie_check(lg, ids, want, cfg.vocab_size)
            check(bad == 0, f"{what} teacher-forced step {g}: K5/K6 ids "
                  f"break the near-tie rule")
            ties += t
            tok = want
    del cache_p, cache_k, head
    return ties, tok.shape[0] * (G - 1)


def hold_prefill(cfg, params, kw, kern_flags, cache_tol, what, rec=None):
    """The kernel-route prefill against the plain route's at full width on
    one prompt: last logits within tol·max|logit|, every fp32 cache leaf
    within tol of its largest value, every bf16 leaf within tol plus one
    bf16 ulp at the top binade (2^-7·max), the first ids under the
    near-tie rule. ``cache_tol()`` gives tol after the kernel prefill (the
    SSD's eps needs its max|cum|, recorded by ``rec``). Returns (logit
    error, its bound, worst ratio of a cache leaf's error to its bound,
    near-tie exceptions, the plain cache, the plain greedy ids)."""
    B, S, G = kw["batch"], kw["prompt_len"], kw["gen_len"]
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            **kern_flags))
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
        lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        if rec is not None:
            kops.ssd = rec
        try:
            lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        finally:
            if rec is not None:
                kops.ssd = rec.real
        tol = cache_tol()
        lerr = float((lg_k - lg_p).abs().max())
        lbound = tol * float(lg_p.abs().max())
        check(lerr <= lbound, f"{what} prefill logits differ by {lerr:.3e} "
              f"(bound {lbound:.3e})")
        cratio = 0.0
        for (path, a), (_, b) in zip(tree_paths(cache_k),
                                     tree_paths(cache_p)):
            for i in range(a.shape[0]):      # layer by layer
                x, y = a[i].float(), b[i].float()
                top = float(y.abs().max())
                bound = tol * top + (2.0 ** -7 * top if b.dtype ==
                                     torch.bfloat16 else 0.0)
                e = float((x - y).abs().max())
                check(e <= bound, f"{what} prefill cache {path}[{i}]: "
                      f"differs by {e:.3e} (bound {bound:.3e})")
                cratio = max(cratio, e / bound if bound else 0.0)
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        ties, bad = ref.near_tie_check(lg_p, sample_ids(lg_k, 0.0,
                                                        cfg.vocab_size),
                                       want, cfg.vocab_size)
        check(bad == 0, f"{what} prefill: the kernel route's first ids "
              f"break the near-tie rule")
    del cache_k, lg_k
    torch.cuda.empty_cache()
    return lerr, lbound, cratio, ties, cache_p, want, plain


def zamba_phase():
    """10a: zamba2-2.7b served at full width and depth through K7, K4, K5
    and K6; its prefill's device time by kernel; the kernel prefill held
    against the plain one (``ssd_chunked`` + dense attention) and the K5/K6
    decode against the plain decode, teacher-forced. 10b: continuous
    batching on 8 slots, three requests held against solo serving."""
    steps = ZAMBA["gen_len"] - 1
    flags = dict(use_ssd_kernel=True, use_flash_kernel=True,
                 use_decode_kernel=True)
    print("[chip_smoke] 10a zamba2 serve path: serve('zamba2-2.7b', "
          f"reduced=False, {flags}, {ZAMBA})", flush=True)
    res, counts, peak = serve_path(
        "zamba2-2.7b", ZAMBA,
        {"k4": N_ZAMBA_APPS, "k5": K5_PER_CALL * N_ZAMBA_APPS * steps,
         "k6": steps, "k7": N_ZAMBA_LAYERS}, **flags)
    del res
    cfg, params = full_params("zamba2-2.7b")
    prof = prefill_profile(cfg, params, ZAMBA, use_ssd_kernel=True,
                           use_flash_kernel=True)
    check(prof["prefill_k7_launches"] == 2 * N_ZAMBA_LAYERS
          and prof["prefill_k4_launches"] == N_ZAMBA_APPS,
          f"profiled prefill launches K7 {prof['prefill_k7_launches']}, "
          f"K4 {prof['prefill_k4_launches']}")
    s = cfg.ssm
    S = ZAMBA["prompt_len"]
    rec = CumRecorder()
    # K7 as mamba_teacher_forced's eps; K4 within 2e-5·max|v| of its plain
    # version, which the shared block's MLP and later layers carry to the
    # logits: 1e-4 of their largest, as the long-prompt K4 path is held
    tol = lambda: U * (4 * rec.max + s.d_state + s.chunk + 2 * (S // s.chunk)
                       + 8) + 1e-4
    lerr, lbound, cratio, ties, cache_p, tok, plain = hold_prefill(
        cfg, params, ZAMBA, dict(use_ssd_kernel=True, use_flash_kernel=True),
        tol, "zamba2", rec)
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    dties, n_ids = decode_same_cache(cfg, params, cache_p, tok, S,
                                     ZAMBA["gen_len"], kern, plain,
                                     "zamba2")
    del cache_p
    torch.cuda.empty_cache()
    print(f"[chip_smoke] 10a K7 + K4 prefill vs ssd_chunked + dense prefill, "
          f"full width: last logits max abs {lerr:.3e} (bound {lbound:.3e},"
          f" max|cum| {rec.max:.1f}), cache leaves at {cratio:.3f} of their "
          f"bounds at worst, first ids near-tie exceptions {ties}; K5/K6 "
          f"decode vs plain from one cache: {n_ids} ids, near-tie "
          f"exceptions {dties}", flush=True)
    print(f"[chip_smoke] 10b serve_continuous('zamba2-2.7b', reduced=False, "
          f"{flags}, {ZTRACE})", flush=True)
    _, ccounts, _, _ = continuous_check(
        "zamba2-2.7b", params, ZTRACE, flags, flags,
        {"k7": N_ZAMBA_LAYERS, "k4": N_ZAMBA_APPS}, N_ZAMBA_APPS)
    del params, kern, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "ccounts": ccounts, "peak": peak,
            "prefill": prof}


def qwen3_phase():
    """10c: qwen3-4b served at full width and depth through K4, K5 and K6;
    its prefill's device time by kernel; the K4 prefill held against the
    plain (dense) one, and the K5/K6 decode against the plain decode,
    teacher-forced."""
    steps = QWEN3["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print("[chip_smoke] 10c qwen3 serve path: serve('qwen3-4b', "
          f"reduced=False, {flags}, {QWEN3})", flush=True)
    res, counts, peak = serve_path(
        "qwen3-4b", QWEN3,
        {"k4": N_QWEN3_LAYERS, "k5": K5_PER_CALL * N_QWEN3_LAYERS * steps,
         "k6": steps, "k7": 0}, **flags)
    del res
    cfg, params = full_params("qwen3-4b")
    prof = prefill_profile(cfg, params, QWEN3, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == N_QWEN3_LAYERS,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    # as the long-prompt K4 path: 1e-4 of the largest logit
    lerr, lbound, cratio, ties, cache_p, tok, plain = hold_prefill(
        cfg, params, QWEN3, dict(use_flash_kernel=True), lambda: 1e-4,
        "qwen3")
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    dties, n_ids = decode_same_cache(cfg, params, cache_p, tok,
                                     QWEN3["prompt_len"], QWEN3["gen_len"],
                                     kern, plain, "qwen3")
    print(f"[chip_smoke] 10c K4 prefill vs dense prefill, full width: last "
          f"logits max abs {lerr:.3e} (bound {lbound:.3e}), cache leaves at "
          f"{cratio:.3f} of their bounds at worst, first ids near-tie "
          f"exceptions {ties}; K5/K6 decode vs plain from one cache: "
          f"{n_ids} ids, near-tie exceptions {dties}", flush=True)
    del params, cache_p, kern, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "peak": peak, "prefill": prof}


def register_z12():
    """Full-width zamba2-2.7b cut to 12 layers, registered as ``ARCH_Z12``
    so that ``train.main`` drives it."""
    mod = types.ModuleType("repro_torch.configs.zamba2_2p7b_12l")
    mod.CONFIG = mod.REDUCED = get_config("zamba2-2.7b").replace(
        n_layers=12)
    sys.modules[mod.__name__] = mod
    configs.register(ARCH_Z12, "zamba2_2p7b_12l")


def zamba_train_phase():
    """10d: savic on full-width zamba2-2.7b cut to 12 layers (two
    applications of the shared block), M = 4, H = 2, b = 8, S = 128, 2
    rounds through ``train.main`` on the fused loop (K1 once a local step),
    on the plain SSD and attention routes; then fused against tree at 6
    layers (one application)."""
    register_z12()
    argv = ["--arch", ARCH_Z12, "--method", "savic", "--use-fused-kernel",
            "--rounds", "2", "--h-local", str(H_LOCAL), "--clients", "4",
            "--batch", "8", "--seq", "128", "--device", "cuda"]
    cfg = get_config(ARCH_Z12)
    with FakeTensorMode():              # the tree's size, with no storage
        n = tree_size(build_model(cfg).init(torch.Generator()))
    print(f"[chip_smoke] 10d zamba2 training, full width, 12 layers (n = "
          f"{n} in the tree; param_count() {cfg.param_count()}): "
          f"train.main " + " ".join(argv), flush=True)
    log, k1, _, peak = main_path(argv, 2 * H_LOCAL)
    check(all(finite(rec["loss"]) for rec in log), "zamba2 loss not finite")
    worst, _, k1_6 = fused_vs_tree(
        "zamba2 savic", cfg=get_config("zamba2-2.7b").replace(n_layers=6))
    return {"k1": k1, "n": n, "peak": peak,
            "walls": [r["wall_s"] for r in log],
            "tokens_per_s": [r["tokens_per_s"] for r in log],
            "fused_vs_tree": worst, "k1_6": k1_6}


def new_shape_kernels(gen):
    """K4, K5, K6 and K7 held against their plain versions at the shapes
    zamba2's and qwen3's serves give them, and timed there. Returns the
    per-kernel errors and timing dicts."""
    out = {"k4_err": 0.0, "k5_err": 0.0, "k6_err": 0.0, "k7_err": 0.0}
    for shape in (K4_ZAMBA, K4_QWEN3, (1, 256, 32, 32, 80),
                  (1, 1000, 32, 32, 80)):
        err, bound = k4_case(*shape, 0, 0.0, torch.float32, gen)
        out["k4_err"] = max(out["k4_err"], err)
        print(f"[chip_smoke] K4 B,S,H,Hk,D={shape}: max abs {err:.3e} "
              f"(bound {bound:.1e})", flush=True)
        check(err <= bound, f"K4 differs from its plain version at {shape}")
    for B_, C_, Hk_, rep_, D_ in (K5_ZAMBA, K5_QWEN3, (8, 320, 32, 1, 80),
                                  (1, 4099, 32, 1, 80)):
        for cap in (0.0, 30.0):
            err, bound = k5_case(B_, C_, Hk_, rep_, D_, cap, gen)
            out["k5_err"] = max(out["k5_err"], err)
            print(f"[chip_smoke] K5 B={B_} C={C_} Hk={Hk_} rep={rep_} "
                  f"D={D_} softcap={cap} plan "
                  f"{ds.attention_plan(B_, Hk_, C_)}: max abs {err:.3e} "
                  f"(bound {bound:.1e})", flush=True)
            check(err <= bound, "K5 differs from its plain version")
    for name, B_ in (("zamba2-2.7b", ZAMBA["batch"]),
                     ("zamba2-2.7b", ZTRACE["slots"]),
                     ("qwen3-4b", QWEN3["batch"])):
        for greedy in (True, False):
            ties, bad, err = k6_case(B_, greedy, gen, head=WIDE_HEADS[name])
            out["k6_err"] = max(out["k6_err"], err)
            print(f"[chip_smoke] K6 {name} head B={B_} "
                  f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions"
                  f" {ties}, violations {bad}, winning logit max abs "
                  f"{err:.3e}", flush=True)
            check(bad == 0, f"K6 breaks the near-tie rule at {name}'s head")
    for shape, a in ((K7_ZAMBA, None), (K7_ZAMBA_ONE, None),
                     (K7_ZAMBA_ONE, -16.0)):
        err, ratio, eps, cmax, groups = k7_case(*shape, a, True, gen)
        out["k7_err"] = max(out["k7_err"], err)
        print(f"[chip_smoke] K7 B,S,H,P,N,Q={shape} A="
              f"{'-linspace(1, 16)' if a is None else a} B/C head stride 0 "
              f"({groups} G group): max abs {err:.3e}, worst error at "
              f"{ratio:.3f} of its bound (eps {eps:.2e}, max|cum| "
              f"{cmax:.1f})", flush=True)
        check(ratio <= 1.0, f"K7 differs from its plain version at {shape}")
    out["k4"] = {"zamba2": time_k4(gen, K4_ZAMBA),
                 "qwen3": time_k4(gen, K4_QWEN3)}
    out["k5"] = {"zamba2": time_k5(K5_ZAMBA, gen),
                 "qwen3": time_k5(K5_QWEN3, gen)}
    out["k6"] = {name: time_k6(gen, B_, WIDE_HEADS[name]) for name, B_ in
                 (("zamba2-2.7b", ZAMBA["batch"]),
                  ("qwen3-4b", QWEN3["batch"]))}
    out["k7"] = {"zamba2": time_k7(gen, K7_ZAMBA),
                 "zamba2_one": time_k7(gen, K7_ZAMBA_ONE)}
    for key, t in out["k4"].items():
        print(f"[chip_smoke] K4 at {key}'s prefill shape "
              f"{K4_ZAMBA if key == 'zamba2' else K4_QWEN3}: "
              f"{t['ms']:.3f} ms/launch (device {t['device_ms']:.3f} ms), "
              f"plain {t['plain_ms']:.3f} ms, chunked "
              f"{t['chunked_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.3f} ms (operations on the true D: "
              f"{t['flops'] / 1e9:.2f} GFLOP), achieved "
              f"{t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s", flush=True)
    for key, t in out["k5"].items():
        print(f"[chip_smoke] K5 at {key}'s decode shape "
              f"{K5_ZAMBA if key == 'zamba2' else K5_QWEN3}: "
              f"{t['ms'] * 1e3:.2f} us/call back to back, device "
              f"{t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us (device "
              f"{t['plain_device_ms'] * 1e3:.2f}), SDPA "
              f"{t['library_ms'] * 1e3:.2f} us (device "
              f"{t['library_device_ms'] * 1e3:.2f}), bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B), plan split "
              f"{t['plan']}", flush=True)
    for key, t in out["k6"].items():
        print(f"[chip_smoke] K6 at {key}'s head: {t['ms'] * 1e3:.2f} "
              f"us/call, plain {t['plain_ms'] * 1e3:.2f} us, matmul + argmax "
              f"{t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    for key, t in out["k7"].items():
        print(f"[chip_smoke] K7 at {key} "
              f"{K7_ZAMBA if key == 'zamba2' else K7_ZAMBA_ONE}: "
              f"{t['ms'] * 1e3:.2f} us/call back to back, device "
              f"{t['device_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, whole ssd_chunked "
              f"{t['chunked_ms'] * 1e3:.2f} us, K7 route "
              f"{t['route_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['flops'] / 1e9:.3f} GFLOP), "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound on "
              f"device time", flush=True)
    return out


def phase10(gen):
    """Phase 10 in the order 10a-10d, then the kernels at the new shapes;
    returns what the kernels line and the summary need."""
    t0 = time.perf_counter()
    z = zamba_phase()
    q = qwen3_phase()
    tr = zamba_train_phase()
    ks = new_shape_kernels(gen)
    print(f"[chip_smoke] phase 10: {time.perf_counter() - t0:.1f} s; peaks "
          f"zamba2 serve {z['peak']:.2f} GiB, qwen3 serve {q['peak']:.2f} "
          f"GiB, zamba2 12-layer savic {tr['peak']:.2f} GiB (K1 "
          f"{tr['k1']}, rounds {tr['walls']} s, {tr['tokens_per_s']} "
          f"tokens/s; fused vs tree at 6 layers {tr['fused_vs_tree']:.3e}, "
          f"K1 {tr['k1_6']})", flush=True)
    return {"zamba": z, "qwen3": q, "train": tr, "kernels": ks}


# --------------------------------------------------------------------------- #
# phase 11: gemma3-4b at full width and depth
# --------------------------------------------------------------------------- #


def gemma3_phase():
    """11a: gemma3-4b served at full width and depth through K4 (each of its
    34 layers: 29 with the 1024 window, 5 global), K5 (the window in each
    local layer's bias) and K6 (on the tied table itself); its prefill's
    device time by kernel. 11b: the K4 prefill held against the plain one
    (the chunked ``models/flash.py`` with the same per-layer windows) and
    the K5/K6 decode against the plain decode, teacher-forced from one
    cache."""
    cfg = get_config("gemma3-4b")
    wins = transformer.layer_windows(cfg, cfg.n_layers)
    check(cfg.n_layers == N_GEMMA_LAYERS and cfg.head_dim == K4_GEMMA[4]
          and tuple(i for i, w in enumerate(wins) if w != GEMMA_WINDOW)
          == GEMMA_GLOBAL, f"gemma3-4b's windows {wins}")
    steps = GEMMA["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print("[chip_smoke] 11a gemma3 serve path: serve('gemma3-4b', "
          f"reduced=False, {flags}, {GEMMA}); global layers {GEMMA_GLOBAL}, "
          f"the other {N_GEMMA_LAYERS - len(GEMMA_GLOBAL)} at window "
          f"{GEMMA_WINDOW}", flush=True)
    res, counts, peak = serve_path(
        "gemma3-4b", GEMMA,
        {"k4": N_GEMMA_LAYERS, "k5": K5_PER_CALL * N_GEMMA_LAYERS * steps,
         "k6": steps, "k7": 0}, **flags)
    step_ms = float(np.median(res.per_token_s)) * 1e3
    ttft_ms = res.timings["prefill_s"] * 1e3
    del res
    cfg, params = full_params("gemma3-4b")
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                            use_decode_kernel=True))
    check(kern.sample_head(params)[0].data_ptr()
          == params["embed"]["table"].data_ptr(),
          "K6's head is a copy of gemma3's tied table")
    prof = prefill_profile(cfg, params, GEMMA, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == N_GEMMA_LAYERS,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    # as the long-prompt K4 path: 1e-4 of the largest logit
    lerr, lbound, cratio, ties, cache_p, tok, plain = hold_prefill(
        cfg, params, GEMMA, dict(use_flash_kernel=True), lambda: 1e-4,
        "gemma3")
    dties, n_ids = decode_same_cache(cfg, params, cache_p, tok,
                                     GEMMA["prompt_len"], GEMMA["gen_len"],
                                     kern, plain, "gemma3")
    print(f"[chip_smoke] 11b K4 prefill (per-layer windows) vs chunked "
          f"plain prefill, full width: last logits max abs {lerr:.3e} "
          f"(bound {lbound:.3e}), cache leaves at {cratio:.3f} of their "
          f"bounds at worst, first ids near-tie exceptions {ties}; K5/K6 "
          f"decode vs plain from one cache: {n_ids} ids, near-tie "
          f"exceptions {dties}", flush=True)
    del params, cache_p, kern, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "peak": peak, "prefill": prof,
            "step_ms": step_ms, "ttft_ms": ttft_ms, "lerr": lerr,
            "lbound": lbound, "ties": ties, "dties": dties}


def gemma3_kernels(gen):
    """11c: K4 at gemma3's prefill shape, global and at its window, K5 at
    its decode shape (causal, and with the window in the bias) and K6 at
    its head, held against their plain versions and timed, SDPA beside K4
    and K5 with the backend it took."""
    out = {"k4_err": 0.0, "k5_err": 0.0, "k6_err": 0.0}
    for win in (0, GEMMA_WINDOW):
        err, bound = k4_case(*K4_GEMMA, win, 0.0, torch.float32, gen)
        out["k4_err"] = max(out["k4_err"], err)
        print(f"[chip_smoke] K4 B,S,H,Hk,D={K4_GEMMA} window={win}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, f"K4 differs from its plain version at "
              f"{K4_GEMMA}, window {win}")
    for win in (0, GEMMA_WINDOW):
        for cap in (0.0, 30.0):
            err, bound = k5_case(*K5_GEMMA, cap, gen, window=win)
            out["k5_err"] = max(out["k5_err"], err)
            print(f"[chip_smoke] K5 B,C,Hk,rep,D={K5_GEMMA} window={win} "
                  f"softcap={cap} plan "
                  f"{ds.attention_plan(K5_GEMMA[0], K5_GEMMA[2], K5_GEMMA[1])}"
                  f": max abs {err:.3e} (bound {bound:.1e})", flush=True)
            check(err <= bound, "K5 differs from its plain version at "
                  f"{K5_GEMMA}")
    head = WIDE_HEADS["gemma3-4b"]
    for greedy in (True, False):
        ties, bad, err = k6_case(GEMMA["batch"], greedy, gen, head=head)
        out["k6_err"] = max(out["k6_err"], err)
        print(f"[chip_smoke] K6 gemma3-4b head B={GEMMA['batch']} "
              f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions "
              f"{ties}, violations {bad}, winning logit max abs {err:.3e}",
              flush=True)
        check(bad == 0, "K6 breaks the near-tie rule at gemma3's head")
    out["k4"] = {"global": time_k4(gen, K4_GEMMA),
                 "window": time_k4(gen, K4_GEMMA, GEMMA_WINDOW)}
    out["k5"] = time_k5(K5_GEMMA, gen)
    out["k6"] = time_k6(gen, GEMMA["batch"], head)
    for key, t in out["k4"].items():
        print(f"[chip_smoke] K4 at gemma3's prefill shape {K4_GEMMA} {key}: "
              f"{t['ms']:.3f} ms/launch (device {t['device_ms']:.3f} ms), "
              f"plain {t['plain_ms']:.3f} ms, chunked "
              f"{t['chunked_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms "
              f"({t['library_backend']}), bound {t['bound_ms']:.3f} ms "
              f"({t['flops'] / 1e9:.2f} GFLOP), achieved "
              f"{t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s, "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound "
              f"on device time", flush=True)
    t = out["k5"]
    print(f"[chip_smoke] K5 at gemma3's decode shape {K5_GEMMA}: "
          f"{t['ms'] * 1e3:.2f} us/call back to back, device "
          f"{t['device_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
          f"us (device {t['plain_device_ms'] * 1e3:.2f}), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{t['library_device_ms'] * 1e3:.2f}; {t['library_backend']}), "
          f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B), plan split "
          f"{t['plan']}", flush=True)
    t = out["k6"]
    print(f"[chip_smoke] K6 at gemma3's head (B={GEMMA['batch']}): "
          f"{t['ms'] * 1e3:.2f} us/call, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"matmul + argmax {t['library_ms'] * 1e3:.2f} us, bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    return out


def phase11(gen):
    """Phase 11: 11a-11b, then the kernels at gemma3's shapes (11c)."""
    t0 = time.perf_counter()
    g = gemma3_phase()
    ks = gemma3_kernels(gen)
    n_glob = len(GEMMA_GLOBAL)
    bound = (n_glob * ks["k4"]["global"]["bound_ms"]
             + (N_GEMMA_LAYERS - n_glob) * ks["k4"]["window"]["bound_ms"])
    print(f"[chip_smoke] phase 11: {time.perf_counter() - t0:.1f} s; gemma3 "
          f"serve peak {g['peak']:.2f} GiB, TTFT {g['ttft_ms']:.1f} ms, "
          f"median step {g['step_ms']:.2f} ms; the prefill's K4 "
          f"{g['prefill']['prefill_k4_ms']:.2f} ms against a bound of "
          f"{bound:.2f} ms", flush=True)
    return {"gemma3": g, "kernels": ks}


# --------------------------------------------------------------------------- #
# phase 12: qwen2-moe-a2.7b at full width and depth
# --------------------------------------------------------------------------- #


def moe_layer_hold(cfg, params, prompt):
    """12b, layer by layer: the plain route's input to each of the 24
    layers goes through the block on both routes (dense attention; K4).
    K4's output is held against its plain version (``k4_plain``) on the
    very q, k and v it got, within 2e-5·max|v| (``k4_case``'s bound); the
    two routings are held under the near-tie rule, layer by layer (each
    layer's first differences against the probability differences of the
    tokens that agreed). Returns (worst K4 error / bound, routing
    differences, their worst margin / bound, the largest router
    probability difference, the largest block-output difference on tokens
    whose routing agreed)."""
    f32 = torch.float32
    tokens = prompt["tokens"]
    S = tokens.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=DEV)
    plain_c, k4_c = Lyr.AttnCall(), Lyr.AttnCall(use_flash_kernel=True)
    K = cfg.moe.top_k
    real_fa, seen = kops.flash_attention, []

    def spy(q, k, v, **kw):
        out = real_fa(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    k4_ratio = worst = eps = xerr = 0.0
    flips = 0
    with torch.inference_mode():
        x = Lyr.embed(params["embed"], tokens, f32)
        layers = transformer._layers(params["blocks"]["stack"], cfg.n_layers)
        for i, bp in enumerate(layers):
            with RouteRecorder(moe_mod) as rp:
                xp, _, _ = transformer._attn_block(bp, cfg, x, pos,
                                                   transformer.HUGE_WINDOW,
                                                   plain_c, f32)
            kops.flash_attention = spy
            try:
                with RouteRecorder(moe_mod) as rk:
                    xk, _, _ = transformer._attn_block(
                        bp, cfg, x, pos, transformer.HUGE_WINDOW, k4_c, f32)
            finally:
                kops.flash_attention = real_fa
            q, k, v, kw, out = seen.pop()
            check(not kw.get("window") and not seen,
                  f"moe layer {i}: K4 called with {kw}")
            err = float((out - k4_plain(q, k, v)).abs().max())
            bound = 2e-5 * float(v.abs().max())
            check(err <= bound, f"moe layer {i}: K4 differs from its plain "
                  f"version by {err:.3e} (bound {bound:.3e})")
            k4_ratio = max(k4_ratio, err / bound)
            del q, k, v, out
            try:
                r = hold_routing(rk.calls, rp.calls, K, MOE_FLIP_FACTOR)
            except AssertionError as e:
                raise RuntimeError(f"chip_smoke: moe layer {i}: {e}")
            flips += r["flips"]
            worst = max(worst, r["worst"])
            eps = max(eps, r["eps"][0])
            same = ~torch.zeros(xp.shape[:2], dtype=torch.bool, device=DEV)
            if r["flips"]:
                pk = torch.sort(rk.calls[0]["eidx"], -1).values
                pp = torch.sort(rp.calls[0]["eidx"], -1).values
                same = ~(pk != pp).any(-1)
            xerr = max(xerr, float((xk - xp).abs()[same].max()))
            x = xp
            del xk, rp, rk
    torch.cuda.empty_cache()
    return k4_ratio, flips, worst, eps, xerr


def moe_prefill_hold(cfg, params, prompt, S, G, plain, kern):
    """12b, end to end: the K4 prefill against the plain (dense) one on the
    same prompt, every layer's routing recorded on both. Every token's
    first routing difference is held as a near tie; a batch row in which
    no token's routing differed is held as ``hold_prefill`` holds one (last
    logits within 1e-4·max|logit|, first ids under the near-tie rule); the
    bf16 K/V cache of layer l is held (1e-4 of its largest value plus one
    bf16 ulp at the top binade) on the rows whose routing agreed in every
    layer before l. Returns a dict of what it found, the plain cache and
    the plain greedy ids."""
    K = cfg.moe.top_k
    with torch.inference_mode():
        with RouteRecorder(moe_mod) as rp:
            lg_p, cache_p = plain.prefill_cache(params, prompt, S + G)
        with RouteRecorder(moe_mod) as rk:
            lg_k, cache_k = kern.prefill_cache(params, prompt, S + G)
        try:
            r = hold_routing(rk.calls, rp.calls, K, MOE_FLIP_FACTOR)
        except AssertionError as e:
            raise RuntimeError(f"chip_smoke: moe prefill routing: {e}")
        B = lg_p.shape[0]
        clean = [b for b in range(B) if b not in r["rows"]]
        lerr = (lg_k - lg_p).abs().amax(-1)
        lbound = 1e-4 * float(lg_p.abs().max())
        for b in clean:
            check(float(lerr[b]) <= lbound, f"moe prefill row {b}: logits "
                  f"differ by {float(lerr[b]):.3e} (bound {lbound:.3e})")
        want = sample_ids(lg_p, 0.0, cfg.vocab_size)
        got = sample_ids(lg_k, 0.0, cfg.vocab_size)
        ties = 0
        if clean:
            ties, bad = ref.near_tie_check(lg_p[clean], got[clean],
                                           want[clean], cfg.vocab_size)
            check(bad == 0, "moe prefill: the K4 route's first ids break "
                  "the near-tie rule")
        before = torch.zeros(B, dtype=torch.bool, device=DEV)
        cratio, held = 0.0, 0
        for i in range(cfg.n_layers):
            rows = ~before
            for key in ("k", "v"):
                a = cache_k[key][i][rows].float()
                b = cache_p[key][i][rows].float()
                if not a.numel():
                    continue
                top = float(b.abs().max())
                bound = 1e-4 * top + 2.0 ** -7 * top
                e = float((a - b).abs().max())
                check(e <= bound, f"moe prefill cache {key}[{i}]: differs "
                      f"by {e:.3e} (bound {bound:.3e})")
                cratio = max(cratio, e / bound)
            held += int(rows.sum())
            before |= r["layer_rows"][i]
        # per MoE layer, the share of routed choices dropped by capacity
        drops = [float(1.0 - c["keep"].float().mean()) for c in rk.calls]
    out = {"routing": r, "clean": clean, "lerr": [float(e) for e in lerr],
           "lbound": lbound, "ties": ties, "cratio": cratio,
           "cache_rows_held": held, "drops": drops,
           "ids_equal": int((got == want).sum())}
    del cache_k, lg_k, rp, rk
    torch.cuda.empty_cache()
    return out, cache_p, want


def moe_decode_hold(cfg, params, cache, tok, S, G, kern, plain):
    """12b, decode: K5/K6 against the plain decode, each from its own clone
    of one prefill cache, teacher-forced on the plain route's greedy
    tokens, every step's routing recorded on both. A row whose routing
    differed in a step (a near tie, held as such) parts there and is
    compared no further; the other rows' ids are held under the near-tie
    rule. Returns (near-tie exceptions, ids compared, routing differences,
    {row: step it parted})."""
    K = cfg.moe.top_k
    clone = lambda c: tree_map(lambda t: t.clone(), c)
    cache_p, cache_k = clone(cache), clone(cache)
    head = kern.sample_head(params)
    live = torch.ones(tok.shape[0], dtype=torch.bool, device=DEV)
    ties = compared = flips = 0
    parted = {}
    with torch.inference_mode():
        for g in range(G - 1):
            with RouteRecorder(moe_mod) as rp:
                lg, cache_p = plain.decode(params, cache_p, tok, S + g)
            zeros = torch.zeros_like(lg)
            with RouteRecorder(moe_mod) as rk:
                ids, cache_k = kern.decode_sample(params, cache_k, tok,
                                                  S + g, zeros, head)
            try:
                r = hold_routing(rk.calls, rp.calls, K, MOE_FLIP_FACTOR,
                                 live=live)
            except AssertionError as e:
                raise RuntimeError(f"chip_smoke: moe decode step {g}: {e}")
            flips += r["flips"]
            for b in r["rows"]:
                parted[b] = g
                live[b] = False
            want = sample_ids(lg, 0.0, cfg.vocab_size)
            rows = torch.nonzero(live).flatten()
            if rows.numel():
                t, bad = ref.near_tie_check(lg[rows], ids[rows], want[rows],
                                            cfg.vocab_size)
                check(bad == 0, f"moe teacher-forced step {g}: K5/K6 ids "
                      f"break the near-tie rule")
                ties += t
                compared += int(rows.numel())
            tok = want
    del cache_p, cache_k, head
    return ties, compared, flips, parted


def moe_phase():
    """12a: qwen2-moe-a2.7b served at full width and depth through K4, K5
    and K6; its prefill's device time by kernel (the routing's sort,
    scatter and gather kernels listed). 12b: the K4 prefill held layer by
    layer and end to end, the K5/K6 decode teacher-forced, every routing
    difference a near tie. 12c: continuous batching on 8 slots, three
    requests held against solo serving."""
    check(torch.cuda.memory_allocated() < 2 ** 30, "phase 12 starts with "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    cfg = get_config(MOE_ARCH)
    check(cfg.n_layers == N_MOE_LAYERS
          and cfg.param_count() == 14_315_587_584
          and moe_mod._capacity(MOE["prompt_len"], cfg.moe) == 176,
          f"{MOE_ARCH}'s config")
    steps = MOE["gen_len"] - 1
    flags = dict(use_flash_kernel=True, use_decode_kernel=True)
    print(f"[chip_smoke] 12a qwen2-moe serve path: serve('{MOE_ARCH}', "
          f"reduced=False, {flags}, {MOE}); {cfg.param_count()} parameters "
          f"({cfg.active_param_count()} active a token), capacity "
          f"{moe_mod._capacity(MOE['prompt_len'], cfg.moe)} a row in the "
          f"prefill", flush=True)
    res, counts, peak = serve_path(
        MOE_ARCH, MOE,
        {"k4": N_MOE_LAYERS, "k5": K5_PER_CALL * N_MOE_LAYERS * steps,
         "k6": steps, "k7": 0}, **flags)
    step_ms = float(np.median(res.per_token_s)) * 1e3
    ttft_ms = res.timings["prefill_s"] * 1e3
    tok_s = res.timings["tok_per_s"]
    del res
    cfg, params = full_params(MOE_ARCH)
    prof = prefill_profile(cfg, params, MOE, use_flash_kernel=True)
    check(prof["prefill_k4_launches"] == N_MOE_LAYERS,
          f"profiled prefill launches K4 {prof['prefill_k4_launches']}")
    disp = prof["prefill_dispatch_kernels"]
    share = prof["prefill_dispatch_ms"] / prof["prefill_device_ms"] * 100
    print(f"[chip_smoke]   routing's sort / scatter / gather / index "
          f"kernels: {prof['prefill_dispatch_ms']:.2f} ms ({share:.1f} % of "
          f"the prefill): "
          f"{[(e['name'][:40], round(e['ms'], 2)) for e in disp[:6]]}",
          flush=True)
    B, S, G = MOE["batch"], MOE["prompt_len"], MOE["gen_len"]
    prompt = sample_batch(cfg, rng.TorchStream(1), B, S, DEV)
    k4r, lflips, lworst, leps, xerr = moe_layer_hold(cfg, params, prompt)
    print(f"[chip_smoke] 12b K4 layer by layer (the plain route's input to "
          f"each of {N_MOE_LAYERS} layers): K4 at {k4r:.3f} of its bound at "
          f"worst; routing differences {lflips} (worst margin at "
          f"{lworst:.3f} of {MOE_FLIP_FACTOR}·eps), router probabilities "
          f"within {leps:.3e}, block outputs within {xerr:.3e} where the "
          f"routing agreed", flush=True)
    plain = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build_model(cfg, ModelCallConfig(dtype=torch.float32, **flags))
    e2e, cache_p, tok = moe_prefill_hold(cfg, params, prompt, S, G, plain,
                                         kern)
    r, d = e2e["routing"], e2e["drops"]
    print(f"[chip_smoke] 12b K4 prefill vs dense prefill end to end: "
          f"routing differences {r['flips']} token-layers ({r['first']} "
          f"first differences, margins {[f'{m:.2e}' for m in r['margins']]},"
          f" worst at {r['worst']:.3f} of {MOE_FLIP_FACTOR}·eps, eps "
          f"{min(r['eps']):.2e}..{max(r['eps']):.2e} over the layers; "
          f"{r['keep_diff']} keep flags moved), rows with a difference "
          f"{r['rows']}; last logits max abs by row "
          f"{[f'{e:.3e}' for e in e2e['lerr']]} (bound {e2e['lbound']:.3e} "
          f"held on rows {e2e['clean']}), first ids equal "
          f"{e2e['ids_equal']}/{B}, near-tie exceptions {e2e['ties']}; "
          f"cache layers at {e2e['cratio']:.3f} of their bounds "
          f"({e2e['cache_rows_held']} layer-rows held)", flush=True)
    print(f"[chip_smoke] 12a routed choices dropped by capacity (C = 176, "
          f"the serve's prompt and weights, K4 route) per layer: min "
          f"{min(d) * 100:.2f} %, median {float(np.median(d)) * 100:.2f} %, "
          f"max {max(d) * 100:.2f} %", flush=True)
    dkern = build_model(cfg, ModelCallConfig(dtype=torch.float32,
                                             use_decode_kernel=True))
    dties, n_ids, dflips, parted = moe_decode_hold(cfg, params, cache_p,
                                                   tok, S, G, dkern, plain)
    del cache_p
    torch.cuda.empty_cache()
    print(f"[chip_smoke] 12b K5/K6 decode vs plain from one cache, "
          f"teacher-forced: {n_ids} ids, near-tie exceptions {dties}; "
          f"routing differences {dflips} (rows parted at a near tie: "
          f"{parted})", flush=True)
    print(f"[chip_smoke] 12c serve_continuous('{MOE_ARCH}', reduced=False, "
          f"{flags}, {MOE_TRACE})", flush=True)
    cres, ccounts, _, _ = continuous_check(
        MOE_ARCH, params, MOE_TRACE, flags, flags, {"k4": N_MOE_LAYERS},
        N_MOE_LAYERS)
    cm = cres.metrics
    del params, kern, dkern, plain, cres
    torch.cuda.empty_cache()
    return {"counts": counts, "ccounts": ccounts, "peak": peak,
            "prefill": prof, "step_ms": step_ms, "ttft_ms": ttft_ms,
            "tok_s": tok_s, "e2e_flips": r["flips"], "drops": d,
            "layer_flips": lflips, "decode_flips": dflips,
            "ring_p50_ms": cm["p50_step_s"] * 1e3}


def moe_kernels(gen):
    """12d: K4, K5 and K6 held against their plain versions at the shapes
    qwen2-moe's serve and ring give them, and timed at the serve's, SDPA
    and matmul + argmax beside them, with the SDPA backend."""
    out = {"k4_err": 0.0, "k5_err": 0.0, "k6_err": 0.0}
    for shape in (K4_MOE, (1, 256, 16, 16, 128)):
        err, bound = k4_case(*shape, 0, 0.0, torch.float32, gen)
        out["k4_err"] = max(out["k4_err"], err)
        print(f"[chip_smoke] K4 B,S,H,Hk,D={shape}: max abs {err:.3e} "
              f"(bound {bound:.1e})", flush=True)
        check(err <= bound, f"K4 differs from its plain version at {shape}")
    for shape in (K5_MOE, K5_MOE_RING):
        for cap in (0.0, 30.0):
            err, bound = k5_case(*shape, cap, gen)
            out["k5_err"] = max(out["k5_err"], err)
            print(f"[chip_smoke] K5 B,C,Hk,rep,D={shape} softcap={cap} plan "
                  f"{ds.attention_plan(shape[0], shape[2], shape[1])}: max "
                  f"abs {err:.3e} (bound {bound:.1e})", flush=True)
            check(err <= bound, f"K5 differs from its plain version at "
                  f"{shape}")
    for B_ in (MOE["batch"], MOE_TRACE["slots"]):
        for greedy in (True, False):
            ties, bad, err = k6_case(B_, greedy, gen, head=MOE_HEAD)
            out["k6_err"] = max(out["k6_err"], err)
            print(f"[chip_smoke] K6 qwen2-moe head B={B_} "
                  f"{'greedy' if greedy else 'gumbel'}: near-tie exceptions "
                  f"{ties}, violations {bad}, winning logit max abs "
                  f"{err:.3e}", flush=True)
            check(bad == 0, "K6 breaks the near-tie rule at qwen2-moe's head")
    out["k4"] = time_k4(gen, K4_MOE)
    out["k5"] = time_k5(K5_MOE, gen)
    out["k6"] = time_k6(gen, MOE["batch"], MOE_HEAD)
    t = out["k4"]
    print(f"[chip_smoke] K4 at qwen2-moe's prefill shape {K4_MOE}: "
          f"{t['ms']:.3f} ms/launch (device {t['device_ms']:.3f} ms), plain "
          f"{t['plain_ms']:.3f} ms, chunked {t['chunked_ms']:.3f} ms, SDPA "
          f"{t['library_ms']:.3f} ms ({t['library_backend']}), bound "
          f"{t['bound_ms']:.3f} ms ({t['flops'] / 1e9:.2f} GFLOP), "
          f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of the bound on "
          f"device time", flush=True)
    t = out["k5"]
    print(f"[chip_smoke] K5 at qwen2-moe's decode shape {K5_MOE}: "
          f"{t['ms'] * 1e3:.2f} us/call back to back, device "
          f"{t['device_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
          f"us (device {t['plain_device_ms'] * 1e3:.2f}), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{t['library_device_ms'] * 1e3:.2f}; {t['library_backend']}), "
          f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B), plan split "
          f"{t['plan']}", flush=True)
    t = out["k6"]
    print(f"[chip_smoke] K6 at qwen2-moe's head (B={MOE['batch']}): "
          f"{t['ms'] * 1e3:.2f} us/call, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"matmul + argmax {t['library_ms'] * 1e3:.2f} us, bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    return out


def phase12(gen):
    """Phase 12: 12a-12c, then the kernels at qwen2-moe's shapes (12d)."""
    t0 = time.perf_counter()
    m = moe_phase()
    ks = moe_kernels(gen)
    p = m["prefill"]
    print(f"[chip_smoke] phase 12: {time.perf_counter() - t0:.1f} s; "
          f"qwen2-moe serve peak {m['peak']:.2f} GiB, TTFT "
          f"{m['ttft_ms']:.1f} ms, median step {m['step_ms']:.2f} ms "
          f"({m['tok_s']:.2f} tokens/s), ring p50 step "
          f"{m['ring_p50_ms']:.2f} ms; the prefill's device time "
          f"{p['prefill_device_ms']:.1f} ms (K4 {p['prefill_k4_ms']:.2f} ms "
          f"against a bound of {N_MOE_LAYERS * ks['k4']['bound_ms']:.2f} ms, "
          f"GEMMs {p['prefill_gemm_ms']:.1f}, rest "
          f"{p['prefill_other_ms']:.1f})", flush=True)
    return {"moe": m, "kernels": ks}


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


def fused_vs_tree(name, rounds=1, flips=False, H=2, cfg=None, **method_kw):
    """``rounds`` rounds at full width and 2 layers (or ``cfg``, a
    full-width config cut in depth): fused client loop
    against the tree loop from the same start, same batches, same rng
    streams. Every float leaf must agree to 1e-5 of its scale (the EF
    residual's and the staleness FIFO's scale is the matching params leaf's:
    u − C(u) and the averaged deltas x̄ − x_t cancel to ulps of the params). ``flips`` (int8 rounds): where the two loops' deltas
    differ in the last bits at an integer boundary, floor(v + u) flips q by
    one; up to 1e-4 of a leaf's elements may then differ by up to 2e-4 of
    its scale. Returns (worst relative difference, flipped elements, K1
    launches of the fused run)."""
    cfg = cfg or get_config("qwen2-0.5b").replace(n_layers=2)
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
    print(f"[chip_smoke] fused vs tree ({name}, {cfg.n_layers} layers, "
          f"{rounds} rounds): "
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


# --------------------------------------------------------------------------- #
# phase 9: checkpoint and bitwise resume
# --------------------------------------------------------------------------- #

CKPT_ROOT = os.path.join(ROOT, ".chip_smoke_ckpt")   # on disk, git-ignored
MEASURED = ("wall_s", "tokens_per_s")
ARCH_2L = "qwen2-0.5b-2l"                 # full width, 2 layers (as 8d)
FIFO_INT8_PERSONAL = ["--method", "fedadam", "--compression",
                      "int8-stochastic", "--error-feedback", "--async-buffer",
                      "2", "--personalize", "final_norm"]
CTRL_TOPK_HM = ["--h-local", str(H_KNOBS), "--controller", "--async-buffer",
                "2", "--het-model", "lognormal", "--het-seed", "0",
                "--compression", "topk", "--compression-k", "0.1",
                "--error-feedback", "--ctrl-noise-target", "1e-3"]


def det(rec):
    return {k: v for k, v in rec.items() if k not in MEASURED}


def sha256_file(path, chunk=1 << 26):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def step_files(d, step):
    """(sha256 of data.bin, state.msgpack's bytes, data.bin's size)."""
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        manifest = f.read()
    data = os.path.join(path, "data.bin")
    return sha256_file(data), manifest, os.path.getsize(data)


def rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class CkptIO:
    """Times every ``checkpoint.save`` and ``checkpoint.restore`` that
    ``train.main`` makes while it is entered (it swaps the package's two
    functions and puts them back on exit), and samples the host's resident
    memory every 2 ms during a restore, beside ``getrusage``'s peak of the
    process so far."""

    def __init__(self):
        self.saves, self.restores = [], []

    def __enter__(self):
        self._save, self._restore = ckpt_lib.save, ckpt_lib.restore

        def save(d, step, state, keep=3):
            t0 = time.perf_counter()
            path = self._save(d, step, state, keep)
            self.saves.append({"step": step, "s": time.perf_counter() - t0,
                               "bytes": os.path.getsize(
                                   os.path.join(path, "data.bin"))})
            return path

        def restore(d, template, step=None):
            before = rss_bytes()
            peak, done = [before], threading.Event()

            def sample():
                while not done.wait(0.002):
                    peak[0] = max(peak[0], rss_bytes())
            th = threading.Thread(target=sample)
            th.start()
            t0 = time.perf_counter()
            try:
                out = self._restore(d, template, step)
                torch.cuda.synchronize()
            finally:
                done.set()
                th.join()
            sec = time.perf_counter() - t0
            peak[0] = max(peak[0], rss_bytes())
            self.restores.append({
                "step": out[1], "s": sec, "rss_before": before,
                "rss_peak_sampled": peak[0],
                "ru_maxrss": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024,
                "bytes": os.path.getsize(os.path.join(
                    d, f"step_{out[1]:08d}", "data.bin"))})
            return out

        ckpt_lib.save, ckpt_lib.restore = save, restore
        return self

    def __exit__(self, *exc):
        ckpt_lib.save, ckpt_lib.restore = self._save, self._restore
        return False


class Tee:
    """stdout for a run: printed as usual and kept for checking."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def io_line(io):
    out = []
    for s in io.saves:
        out.append(f"save step {s['step']} {s['bytes']} B in {s['s']:.2f} s "
                   f"({s['bytes'] / s['s'] / 1e9:.2f} GB/s)")
    for r in io.restores:
        out.append(f"restore step {r['step']} {r['bytes']} B in "
                   f"{r['s']:.2f} s ({r['bytes'] / r['s'] / 1e9:.2f} GB/s); "
                   f"host RSS {r['rss_before'] / 2 ** 30:.2f} GiB before, "
                   f"peak {r['rss_peak_sampled'] / 2 ** 30:.2f} GiB sampled"
                   f", ru_maxrss {r['ru_maxrss'] / 2 ** 30:.2f} GiB (the "
                   f"process's peak so far)")
    return "; ".join(out)


def resume_case(label, argv, t, T, d, expect_k1, expect_k3=0):
    """train(T) against train(t) + restore + train(T − t) through
    ``train.main`` with ``--ckpt``: the resumed run prints the restore and
    logs only rounds t..T-1, equal in every deterministic field; the final
    checkpoints are byte for byte equal (data.bin by sha256, as the first
    run's is deleted before the second writes). ``expect_k1(rounds, log)``
    gives the K1 launches a run needs. Returns what it measured."""
    da, db = os.path.join(d, "a"), os.path.join(d, "b")
    t0 = time.perf_counter()
    with CkptIO() as io_a:
        log_a, k1_a, k3_a, peak_a = main_path(
            argv + ["--rounds", str(T), "--ckpt", da, "--ckpt-every",
                    str(T)], expect_k1, expect_k3 * T)
    th = time.perf_counter()
    sha_a, man_a, size = step_files(da, T)
    hash_s = time.perf_counter() - th
    shutil.rmtree(da)
    with CkptIO() as io_b:
        log_b1, k1_b1, k3_b1, _ = main_path(
            argv + ["--rounds", str(t), "--ckpt", db, "--ckpt-every",
                    str(t)], expect_k1, expect_k3 * t)
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            log_b2, k1_b2, k3_b2, peak_b = main_path(
                argv + ["--rounds", str(T), "--ckpt", db, "--ckpt-every",
                        str(t)], expect_k1, expect_k3 * (T - t))
    check(any(s.startswith(f"[train] restored round {t} ")
              for s in "".join(tee.text).splitlines()),
          f"{label}: the resumed run printed no restore of round {t}")
    check([r["round"] for r in log_b1] == list(range(t)), f"{label}: first "
          f"half logged rounds {[r['round'] for r in log_b1]}")
    check([r["round"] for r in log_b2] == list(range(t, T)),
          f"{label}: resumed run logged rounds "
          f"{[r['round'] for r in log_b2]}")
    for ra, rb in zip(log_a, log_b1 + log_b2):
        check(det(ra) == det(rb), f"{label}: round {ra['round']} differs "
              f"after the restore: {det(ra)} vs {det(rb)}")
    # the restore frees the initial state first and shares the replicated
    # leaves again, so the resumed run needs no more memory than the first
    check(peak_b <= peak_a, f"{label}: the resumed run peaks at "
          f"{peak_b:.2f} GiB, the uninterrupted one at {peak_a:.2f}")
    sha_b, man_b, _ = step_files(db, T)
    check(man_a == man_b, f"{label}: state.msgpack differs")
    check(sha_a == sha_b, f"{label}: data.bin differs ({sha_a} vs {sha_b})")
    shutil.rmtree(db)
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   {label}: {T} rounds straight vs {t} + restore + "
          f"{T - t}: rounds {list(range(t, T))} equal in every "
          f"deterministic field, step {T} data.bin sha256 {sha_a[:16]}… "
          f"equal ({size} B), state.msgpack equal ({len(man_a)} B); K1 "
          f"{k1_a} vs {k1_b1} + {k1_b2}, K3 {k3_a} vs {k3_b1} + {k3_b2}; "
          f"peak {peak_a:.2f} GiB vs {peak_b:.2f} GiB resumed; "
          f"straight: {io_line(io_a)}; split: {io_line(io_b)}; sha256 of "
          f"one data.bin {hash_s:.2f} s; case {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    return {"size": size, "io_a": io_a, "io_b": io_b, "k1": (k1_a, k1_b1,
                                                               k1_b2),
            "k3": (k3_a, k3_b1, k3_b2), "peak": (peak_a, peak_b),
            "walls": [r["wall_s"] for r in log_a]}


def register_2l():
    """Full-width qwen2-0.5b cut to 2 layers, registered as ``ARCH_2L`` so
    that ``train.main`` (and its checkpoints) drive it."""
    mod = types.ModuleType("repro_torch.configs.qwen2_0p5b_2l")
    mod.CONFIG = mod.REDUCED = get_config("qwen2-0.5b").replace(n_layers=2)
    sys.modules[mod.__name__] = mod
    configs.register(ARCH_2L, "qwen2_0p5b_2l")


def resume_phase(n, shapes):
    """9a: full-width qwen2-0.5b savic through K1, 3 rounds straight
    against 2 + restore + 1 (M = 2 where the disk cannot hold two M = 4
    checkpoints); 9b: two 2-layer cases, 4 rounds against 2 + 2. ``n`` is
    the model's parameter count, ``shapes`` its {path: shape}."""
    os.makedirs(CKPT_ROOT, exist_ok=True)
    usage = shutil.disk_usage(CKPT_ROOT)
    fs = subprocess.run(["df", "-hT", CKPT_ROOT], capture_output=True,
                        text=True).stdout.strip().splitlines()[-1]
    need = lambda M: 2 * (2 * M + 1) * n * 4
    M = 4 if usage.free > need(4) + (4 << 30) else 2
    print(f"[chip_smoke] 9a checkpoint dir {CKPT_ROOT}: {usage.free} B free "
          f"of {usage.total} ({fs}); two savic checkpoints at M = 4 need "
          f"{need(4)} B: running at M = {M}", flush=True)
    check(usage.free > need(M) + (1 << 30), f"{usage.free} B free: too few "
          f"for two M = {M} checkpoints")
    argv = main_argv("savic", 3) + ["--clients", str(M)]
    print("[chip_smoke] 9a resume, full width: train.main " + " ".join(argv)
          + " --ckpt ...", flush=True)
    a = resume_case("9a savic", argv, 2, 3, os.path.join(CKPT_ROOT, "9a"),
                    lambda log: len(log) * H_LOCAL)
    # params and momentum (M, n) each, global D (n), fp32; then the int32
    # scalars (the round, D's step count)
    expect = 4 * (2 * M + 1) * n
    check(0 <= a["size"] - expect <= 64, f"9a data.bin {a['size']} B, "
          f"expected (2M + 1)·n·4 = {expect} + a few scalars")
    print(f"[chip_smoke]   9a data.bin {a['size']} B = (2M + 1)·n·4 + "
          f"{a['size'] - expect} B of scalars", flush=True)
    register_2l()
    n_synced = sum("final_norm" not in p for p in shapes)  # K3 a round
    b = []
    for label, flags, k1, k3 in (
            ("9b fedadam int8 + EF + FIFO 2 + personal final_norm",
             FIFO_INT8_PERSONAL, lambda log: len(log) * H_LOCAL, n_synced),
            ("9b savic controller + topk 0.1 + EF + lognormal H_m",
             CTRL_TOPK_HM, launches_for_hm, 0)):
        argv = ["--arch", ARCH_2L, "--use-fused-kernel", "--h-local",
                str(H_LOCAL), "--clients", "4", "--batch", "8", "--seq",
                "128", "--device", "cuda"] + flags
        print(f"[chip_smoke] {label}: train.main " + " ".join(argv)
              + " --ckpt ...", flush=True)
        b.append(resume_case(label, argv, 2, 4,
                             os.path.join(CKPT_ROOT, "9b"), k1, k3))
    return {"M": M, "n": n, "free": usage.free, "a": a, "b": b}


def train_lm_phase():
    """9c: launch/train_lm.py's six methods at the bench's point (reduced
    qwen2-0.5b, M = 4, H = 8, b = 4, S = 64, 10 rounds), then savic at
    full width for 3 rounds; K1 counted over each."""
    F_ = train_lm.FIXED
    t0 = time.perf_counter()
    su.fused_step_flat.launches = 0
    rows = [train_lm.run_method(m, device="cuda")
            for m in train_lm.TRAIN_LM_OVERRIDES]
    k1 = su.fused_step_flat.launches
    check(k1 == len(rows) * F_["rounds"] * F_["h_local"], f"9c K1 {k1}")
    su.fused_step_flat.launches = 0
    full = train_lm.run_method("savic", device="cuda", full=True, rounds=3)
    k1_full = su.fused_step_flat.launches
    check(k1_full == 3 * F_["h_local"], f"9c full-width K1 {k1_full}")
    for r in rows + [full]:
        check(all(finite(v) for v in r["info"]["loss_curve"]),
              f"9c {r['coords']} non-finite loss {r['info']['loss_curve']}")
        print("[chip_smoke]   9c " + json.dumps(r), flush=True)
    print(f"[chip_smoke]   9c summary (reduced) "
          f"{json.dumps(dict(train_lm.summary(rows)))}; full-width savic "
          f"{json.dumps(dict(train_lm.summary([full])))}; K1 {k1} (reduced, "
          f"{len(rows)} × {F_['rounds']} × {F_['h_local']}), {k1_full} (full "
          f"width); {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return {"rows": rows, "full": full, "k1": k1, "k1_full": k1_full}


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
    steps = SERVE["gen_len"] - 1
    print("[chip_smoke] serve main path: serve('qwen2-0.5b', reduced=False, "
          f"use_decode_kernel=True, {SERVE})", flush=True)
    _, counts, speak = serve_path(
        "qwen2-0.5b", SERVE, {"k4": 0, "k5": K5_PER_CALL * 24 * steps,
                              "k6": steps, "k7": 0}, use_decode_kernel=True)
    k5_launches, k6_launches = counts["k5"], counts["k6"]
    cfg_full, sparams = full_params("qwen2-0.5b")
    ties, n_ids = teacher_forced(cfg_full, sparams)
    print(f"[chip_smoke] kernel vs plain decode, teacher-forced, full width: "
          f"{n_ids} ids, near-tie exceptions {ties}", flush=True)

    # ---- 10. continuous batching at full width -----------------------------
    print(f"[chip_smoke] serve_continuous('qwen2-0.5b', reduced=False, "
          f"use_decode_kernel=True, {TRACE})", flush=True)
    flags = dict(use_decode_kernel=True)
    continuous_check("qwen2-0.5b", sparams, TRACE, flags, flags, {}, 24)
    # ---- 10b. long-prompt serve: K4 prefill, K5/K6 decode at C = 8224 -----
    steps = LONG["gen_len"] - 1
    print("[chip_smoke] long-prompt serve path: serve('qwen2-0.5b', "
          f"reduced=False, use_flash_kernel=True, use_decode_kernel=True, "
          f"{LONG})", flush=True)
    _, counts, lpeak = serve_path(
        "qwen2-0.5b", LONG, {"k4": 24, "k5": K5_PER_CALL * 24 * steps,
                             "k6": steps, "k7": 0},
        use_flash_kernel=True, use_decode_kernel=True)
    k4_launches = counts["k4"]
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
    steps = MAMBA["gen_len"] - 1
    flags = dict(use_ssd_kernel=True, use_decode_kernel=True)
    print("[chip_smoke] mamba2 serve path: serve('mamba2-1.3b', "
          f"reduced=False, {flags}, {MAMBA})", flush=True)
    _, counts, mpeak = serve_path(
        "mamba2-1.3b", MAMBA, {"k4": 0, "k5": 0, "k6": steps,
                               "k7": N_MAMBA_LAYERS}, **flags)
    k7_launches = counts["k7"]
    mcfg, mparams = full_params("mamba2-1.3b")
    lerr, lbound, cratio, mties, m_ids, cmax = mamba_teacher_forced(mcfg,
                                                                    mparams)
    print(f"[chip_smoke] K7 route vs ssd_chunked route, teacher-forced, full "
          f"width, prompt {MAMBA['prompt_len']}: last logits max abs "
          f"{lerr:.3e} (bound {lbound:.3e}, max|cum| {cmax:.1f}), cache "
          f"leaves at {cratio:.3f} of their bounds at worst, {m_ids} ids, "
          f"near-tie exceptions {mties}", flush=True)

    # ---- 13b. mamba2 continuous batching at full width ---------------------
    print(f"[chip_smoke] serve_continuous('mamba2-1.3b', reduced=False, "
          f"{flags}, {MTRACE})", flush=True)
    continuous_check("mamba2-1.3b", mparams, MTRACE, flags,
                     dict(use_ssd_kernel=True), {"k7": N_MAMBA_LAYERS}, 0)
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

    # ---- 10. the hybrid (zamba2-2.7b) and qwen3-4b at full width ---------
    p10 = phase10(gen)

    # ---- 11. gemma3-4b at full width and depth ----------------------------
    p11 = phase11(gen)

    # ---- 12. qwen2-moe-a2.7b at full width and depth ----------------------
    p12 = phase12(gen)

    # ---- phase 9. checkpoint and bitwise resume; the train_lm runner ------
    try:
        res = resume_phase(n_main, qwen_shapes)
        tlm = train_lm_phase()
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)

    z, q3, ztr, ks = (p10["zamba"], p10["qwen3"], p10["train"],
                      p10["kernels"])
    g3, gks = p11["gemma3"], p11["kernels"]
    mo, mks = p12["moe"], p12["kernels"]
    by_path = {
        "k1": {"qwen2-0.5b savic": launches,
               "zamba2-2.7b 12-layer savic": ztr["k1"]},
        "k4": {"qwen2-0.5b long prompt": k4_launches,
               "zamba2-2.7b serve": z["counts"]["k4"],
               "zamba2-2.7b continuous": z["ccounts"]["k4"],
               "qwen3-4b serve": q3["counts"]["k4"],
               "gemma3-4b serve": g3["counts"]["k4"],
               "qwen2-moe-a2.7b serve": mo["counts"]["k4"],
               "qwen2-moe-a2.7b continuous": mo["ccounts"]["k4"]},
        "k5": {"qwen2-0.5b serve": k5_launches,
               "zamba2-2.7b serve": z["counts"]["k5"],
               "zamba2-2.7b continuous": z["ccounts"]["k5"],
               "qwen3-4b serve": q3["counts"]["k5"],
               "gemma3-4b serve": g3["counts"]["k5"],
               "qwen2-moe-a2.7b serve": mo["counts"]["k5"],
               "qwen2-moe-a2.7b continuous": mo["ccounts"]["k5"]},
        "k6": {"qwen2-0.5b serve": k6_launches,
               "zamba2-2.7b serve": z["counts"]["k6"],
               "zamba2-2.7b continuous": z["ccounts"]["k6"],
               "qwen3-4b serve": q3["counts"]["k6"],
               "gemma3-4b serve": g3["counts"]["k6"],
               "qwen2-moe-a2.7b serve": mo["counts"]["k6"],
               "qwen2-moe-a2.7b continuous": mo["ccounts"]["k6"]},
        "k7": {"mamba2-1.3b serve": k7_launches,
               "zamba2-2.7b serve": z["counts"]["k7"],
               "zamba2-2.7b continuous": z["ccounts"]["k7"]}}
    shape_times = lambda ts, shapes, keys=("ms", "plain_ms", "bound_ms",
                                           "library_ms", "library_backend",
                                           "device_ms"): [
        {"at": name, "shape": list(shapes[name]),
         **{k: t[k] for k in keys if k in t}} for name, t in ts.items()]
    kernels = [{
        "name": "fused_step_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_step.cu",
        "replaces": "src/repro/kernels/scaled_update.py:201",
        "launches": sum(by_path["k1"].values()),
        "launches_by_path": by_path["k1"], "max_abs_err": max_err, "ms": ms,
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
        "launches": sum(by_path["k5"].values()),
        "launches_by_path": by_path["k5"],
        "max_abs_err": max(k5_err, ks["k5_err"], gks["k5_err"],
                           mks["k5_err"]),
        "ms": k5t["ms"],
        "plain_ms": k5t["plain_ms"], "bound_ms": k5t["bound_ms"],
        "bound_by": "bytes", "library_ms": k5t["library_ms"],
        "device_ms": k5t["device_ms"],
        "at_shapes": shape_times({**ks["k5"], "gemma3": gks["k5"],
                                  "qwen2-moe": mks["k5"]},
                                 {"zamba2": K5_ZAMBA, "qwen3": K5_QWEN3,
                                  "gemma3": K5_GEMMA,
                                  "qwen2-moe": K5_MOE}),
    }, {
        "name": "decode_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_sample.cu",
        "replaces": "src/repro/kernels/decode_step.py:133",
        "launches": sum(by_path["k6"].values()),
        "launches_by_path": by_path["k6"],
        "max_abs_err": max(k6_err, ks["k6_err"], gks["k6_err"],
                           mks["k6_err"]),
        "ms": k6t["ms"],
        "plain_ms": k6t["plain_ms"], "bound_ms": k6t["bound_ms"],
        "bound_by": "bytes", "library_ms": k6t["library_ms"],
        "at_shapes": shape_times({**ks["k6"], "gemma3-4b": gks["k6"],
                                  MOE_ARCH: mks["k6"]}, {
            "zamba2-2.7b": (ZAMBA["batch"], *WIDE_HEADS["zamba2-2.7b"][:3]),
            "qwen3-4b": (QWEN3["batch"], *WIDE_HEADS["qwen3-4b"][:3]),
            "gemma3-4b": (GEMMA["batch"], *WIDE_HEADS["gemma3-4b"][:3]),
            MOE_ARCH: (MOE["batch"], *MOE_HEAD[:3])}),
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:76",
        "launches": sum(by_path["k4"].values()),
        "launches_by_path": by_path["k4"],
        "max_abs_err": max(k4_err, ks["k4_err"], gks["k4_err"],
                           mks["k4_err"]),
        "ms": k4t["ms"],
        "plain_ms": k4t["plain_ms"], "bound_ms": k4t["bound_ms"],
        "bound_by": "operations", "library_ms": k4t["library_ms"],
        "at_shapes": shape_times(
            {**ks["k4"], "gemma3_global": gks["k4"]["global"],
             "gemma3_window1024": gks["k4"]["window"],
             "qwen2-moe": mks["k4"]},
            {"zamba2": K4_ZAMBA, "qwen3": K4_QWEN3,
             "gemma3_global": K4_GEMMA, "gemma3_window1024": K4_GEMMA,
             "qwen2-moe": K4_MOE}),
    }, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:52",
        "launches": sum(by_path["k7"].values()),
        "launches_by_path": by_path["k7"],
        "max_abs_err": max(k7_err, ks["k7_err"]), "ms": k7t["ms"],
        "plain_ms": k7t["plain_ms"], "bound_ms": k7t["bound_ms"],
        "bound_by": "operations", "library_ms": None,
        "device_ms": k7t["device_ms"],
        "at_shapes": shape_times(ks["k7"], {"zamba2": K7_ZAMBA,
                                            "zamba2_one": K7_ZAMBA_ONE}),
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
    a = res["a"]
    print(f"[chip_smoke] phase 9: 9a savic M = {res['M']} checkpoint "
          f"{a['size']} B (n = {res['n']}), {io_line(a['io_b'])}; K1 "
          f"{a['k1'][0]} vs {a['k1'][1]} + {a['k1'][2]}; 9b K1 "
          f"{[b['k1'] for b in res['b']]}, K3 {[b['k3'] for b in res['b']]};"
          f" 9c K1 {tlm['k1']} + {tlm['k1_full']}", flush=True)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
