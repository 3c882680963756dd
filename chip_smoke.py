"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, started together), holds each against its plain
PyTorch version on the card, drives the port's paths through
``repro_torch.launch.train.main`` at the full width of qwen2-0.5b (the SAVIC
round; local-adam; SAVIC with int8-stochastic compression and error
feedback; SAVIC with OASIS and half the clients sampled), holds the fused
client loop against the tree loop, then drives the serving path through
``repro_torch.launch.serve`` at full width (prefill-cache reuse with 63
decode steps on K5 and K6; continuous batching over a ring of 8 slots; an
8192-token prompt at batch 2 prefilled on K4, then 31 decode steps; then
the SSM family: full-width mamba2-1.3b prefilled at batch 4 from a
2048-token prompt through K7 into its recurrent state, 63 decode steps on
K6, and continuous batching of 16 requests on 8 slots), holds the kernel
paths against the plain ones teacher-forced (the K4 prefill against the
chunked ``models/flash.py`` one, the K7 prefill against
``models.ssm.ssd_chunked``), and checks what comes out.
Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
before printing any result.

The second-to-last lines are one JSON object listing the kernels (launches
on the main path, error against the plain version (K4's over its fp32
cases, K7's over all its cases), measured and least possible times) and the
card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``.
"""
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
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import LMRoundLoader, TokenStream  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_step as ds  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quantize_update as qu  # noqa: E402
from repro_torch.kernels import scaled_update as su  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (ModelCallConfig, sample_batch,  # noqa: E402
                                sample_ids)
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.models.flash import flash_attention_bshd  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.utils import rng  # noqa: E402
from repro_torch.utils.tree import tree_paths, tree_size  # noqa: E402

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
# serving: batch 8, prompt 512, 64 tokens (63 decode steps) at full width
SERVE = dict(batch=8, prompt_len=512, gen_len=64)
K5_MAIN = (8, 576, 2, 7, 64)       # B, C, Hk, rep, D of the decode steps
V_PAD, V_REAL, D_MODEL = 153_600, 151_936, 896
TRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
             arrival_rate=0.5, seed=0)
# long-prompt prefill: batch 2, prompt 8192, 32 tokens (31 decode steps)
LONG = dict(batch=2, prompt_len=8192, gen_len=32)
K4_MAIN = (2, 8192, 14, 2, 64)     # B, S, H, Hk, D of the prefill's K4
K5_LONG = (2, 8224, 2, 7, 64)      # B, C, Hk, rep, D of its decode steps
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
            (2, 1000, 14, 2, 64, 0, 0.0, torch.float32)]
# mamba2-1.3b serving: batch 4, prompt 2048, 64 tokens (63 decode steps)
MAMBA = dict(batch=4, prompt_len=2048, gen_len=64)
K7_MAIN = (4, 2048, 64, 64, 128, 256)   # B, S, H, P, N, Q of the prefill's K7
N_MAMBA_LAYERS = 48
MTRACE = dict(slots=8, n_requests=16, prompt_len=256, gen_len=64,
              arrival_rate=0.5, seed=0)
# K7 against its plain version: (B, S, H, P, N, Q, A, shared B/C): the
# prefill's shape with one B/C group over the heads (head stride 0, as the
# model passes them) and per head; Q 64/128 x N 16/64 x P 32/128; one chunk
# (the continuous-batching prefill); A = -16 on every head (largest |cum|)
K7_CASES = [(*K7_MAIN, None, True), (*K7_MAIN, None, False),
            *[(2, 512, 8, P, N, Q, None, False) for Q in (64, 128)
              for N in (16, 64) for P in (32, 128)],
            (1, 256, 64, 64, 128, 256, None, True),
            (*K7_MAIN, -16.0, True)]
U = 2.0 ** -24


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


def k5_case(B, C, Hk, rep, D, cap, gen, one_valid=False):
    """(max abs error, its bound 1e-5·max|v|) of K5 against its plain
    version."""
    q, k, v, bias = k5_inputs(B, C, Hk, rep, D, gen, one_valid)
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


def time_k5(shape, gen):
    """K5 at ``shape`` (B, C, Hk, rep, D): CUDA-event times of the kernel
    wrapper, its plain version and SDPA (the bias as mask over fp32 k/v,
    GQA), and its bound."""
    B, C, Hk, rep, D = shape
    q, k, v, bias = k5_inputs(B, C, Hk, rep, D, gen)
    k5 = {"ms": cuda_ms(lambda: ds.decode_attention(q, k, v, bias), 200),
          "plain_ms": cuda_ms(lambda: ref.decode_attention_ref(q, k, v,
                                                               bias), 100)}
    q4 = q[:, :, None, :]
    kf = k.float().transpose(1, 2).contiguous()      # (B, Hk, C, D)
    vf = v.float().transpose(1, 2).contiguous()
    mask = bias[:, None, None, :]
    lib = F.scaled_dot_product_attention(q4, kf, vf, attn_mask=mask,
                                         enable_gqa=True)[:, :, 0]
    check(float((lib - ref.decode_attention_ref(q, k, v, bias)).abs().max())
          <= 1e-4, "SDPA does not compute K5's function")
    k5["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kf, vf, attn_mask=mask, enable_gqa=True), 200)
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
    model's A_log range) or ``a`` on every head; ``shared``: one B/C group
    expanded over the heads."""
    f = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    x = f(B, S, H, P)
    dt = F.softplus(f(B, S, H))
    A = torch.full((H,), a, device=DEV) if a is not None else \
        -torch.linspace(1.0, 16.0, H, device=DEV)
    if shared:
        Bm = f(B, S, 1, N).expand(B, S, H, N)
        Cm = f(B, S, 1, N).expand(B, S, H, N)
    else:
        Bm, Cm = f(B, S, H, N), f(B, S, H, N)
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
    """K7 against its plain version element by element. Returns (max abs
    error, the worst ratio of an error to its bound, eps, max|cum|)."""
    x, dt, A, Bm, Cm = k7_inputs(B, S, H, P, N, a, shared, gen)
    want = ref.ssd_intra_chunk_ref(x, dt, A, Bm, Cm, Q)
    got = ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
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
    del x, dt, A, Bm, Cm, want, got, mags
    torch.cuda.empty_cache()
    return err, ratio, eps, cmax


def k7_work(B, S, H, P, N, Q):
    """(flops, bytes) K7 must do: per cell the causal half of C·Bᵀ (2N per
    pair i >= j), of (G⊙L)·xdt (2P per pair) and the chunk state (2QNP);
    read x, dt, A and B/C once (one (B, S, N) group each, as the model
    passes them), write Y, S_chunk and total."""
    nc = S // Q
    cells = B * nc * H
    pairs = Q * (Q + 1) // 2
    flops = cells * (pairs * 2 * N + pairs * 2 * P + 2 * Q * N * P)
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N
                  + B * nc * H * N * P + B * nc * H)
    return flops, nbytes


def time_k7(gen):
    """K7 at the prefill's shape (B/C one group over the heads, A as the
    model's): CUDA-event times of the kernel wrapper, its plain version and
    the whole plain SSD (``models.ssm.ssd_chunked``), and its bound. No
    single PyTorch call computes K7's function: no library time."""
    B, S, H, P, N, Q = K7_MAIN
    x, dt, A, Bm, Cm = k7_inputs(B, S, H, P, N, None, True, gen)
    t = {"ms": cuda_ms(lambda: ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, Q), 20),
         "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_ref(x, dt, A, Bm,
                                                             Cm, Q), 3),
         "chunked_ms": cuda_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, Q), 3),
         "route_ms": cuda_ms(lambda: kops.ssd(x, dt, A, Bm, Cm, chunk=Q), 5)}
    t["flops"], t["bytes"] = k7_work(B, S, H, P, N, Q)
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
    check(k5 == 24 * steps, f"K5 launched {k5} times, expected {24 * steps}")
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
    check(k5 == 24 * m["decode_steps"] and k6 == m["decode_steps"],
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
    check(k5 == 24 * steps, f"K5 launched {k5} times, expected {24 * steps}")
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
    peak GiB)."""
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
        print(f"[chip_smoke]   round {rec['round']} loss {rec['loss']:.5f} "
              f"drift {rec['drift']:.4e}{extra} tokens/s "
              f"{rec['tokens_per_s']} wall {rec['wall_s']} s", flush=True)
        check(all(finite(v) for v in rec.values() if isinstance(v, float)),
              f"non-finite record {rec}")
    check(k1 == expect_k1, f"K1 launched {k1} times, expected {expect_k1}")
    check(k3 == expect_k3, f"K3 launched {k3} times, expected {expect_k3}")
    print(f"[chip_smoke]   launches K1 {k1}, K3 {k3}; peak memory "
          f"{peak:.2f} GiB", flush=True)
    return log, k1, k3, peak


def fused_vs_tree(name, rounds=1, flips=False, **method_kw):
    """``rounds`` rounds at full width and 2 layers: fused client loop
    against the tree loop from the same start, same batches, same rng
    streams. Every float leaf must agree to 1e-5 of its scale (the EF
    residual's scale is the matching params leaf's: u − C(u) cancels to ulps
    of the params). ``flips`` (int8 rounds): where the two loops' deltas
    differ in the last bits at an integer boundary, floor(v + u) flips q by
    one; up to 1e-4 of a leaf's elements may then differ by up to 2e-4 of
    its scale. Returns (worst relative difference, flipped elements)."""
    cfg = get_config("qwen2-0.5b").replace(n_layers=2)
    model = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    M, H, b, S = 4, 2, 8, 128
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=0), M, b)
    root = rng.TorchStream(1)
    out = {}
    for fused in (True, False):
        spec = engine.method_spec("savic", gamma=3e-3, use_fused_kernel=fused,
                                  **method_kw)
        gen = torch.Generator(device=DEV).manual_seed(0)
        state = engine.init_state(gen, model.init, spec, M)
        step = engine.build_round_step(model.loss, spec)
        for r in range(rounds):
            batch = {k: torch.from_numpy(v).to(DEV, torch.long)
                     for k, v in loader.round_batch(r, H, S).items()}
            state, met = step(state, batch, root.fold(r))
        out[fused] = (state, float(met["loss"]))
        del state, met
    (sf, lf), (st, lt) = out[True], out[False]
    worst, n_flips = 0.0, 0
    tree = dict(tree_paths(st))
    for (k, a), (_, c) in zip(tree_paths(sf), tree_paths(st)):
        if not a.is_floating_point():
            check(torch.equal(a, c), f"{name}: {k} differs")
            continue
        ref_leaf = tree["params/" + k[3:]] if k.startswith("ef/") else c
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
          f"scale" + (f", {n_flips} int8 boundary flips" if flips else ""),
          flush=True)
    check(abs(lf - lt) <= 1e-5 * abs(lt), f"{name}: fused and tree losses "
          f"differ")
    check(worst <= 1e-5, f"{name}: fused and tree states differ beyond 1e-5")
    return worst, n_flips


def build_all():
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    libs = (su._lib, qu._lib, ds._attention_lib, ds._sample_lib, fa._lib,
            ssd._lib)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        list(pool.map(lambda f: f(), libs))
    for src in ("fused_step.cu", "quantize_update.cu", "decode_attention.cu",
                "decode_sample.cu", "flash_attention.cu",
                "ssd_intra_chunk.cu"):
        info = build.BUILD_LOG.get(src, {"seconds": 0.0, "ptxas": "(cached)"})
        print(f"[chip_smoke] {src}: nvcc {info['seconds']:.2f} s\n"
              f"{info['ptxas']}", flush=True)
    print(f"[chip_smoke] built K1, K3, K4, K5, K6 and K7 in "
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

    # ---- 3. main path: savic, full-width qwen2-0.5b ------------------------
    argv = main_argv("savic", 2)
    print("[chip_smoke] main path: train.main " + " ".join(argv), flush=True)
    log, launches, _, peak = main_path(argv, 2 * H_LOCAL)

    params = build_model(get_config("qwen2-0.5b")).init(
        torch.Generator(device=DEV).manual_seed(0))
    n_main = tree_size(params)          # per-client flat length n
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

    # ---- 8. K5 and K6 against their plain versions ------------------------
    k5_err = 0.0
    B, C, Hk, rep, D = K5_MAIN
    k5_cases = [(C_, cap, False) for C_ in (C, 1, 31, 8192, 32768)
                for cap in (0.0, 30.0)]
    k5_cases += [(C, 0.0, True), (8192, 30.0, True)]
    for C_, cap, one in k5_cases:
        err, bound = k5_case(B, C_, Hk, rep, D, cap, gen, one)
        k5_err = max(k5_err, err)
        print(f"[chip_smoke] K5 B={B} C={C_} Hk={Hk} rep={rep} D={D} "
              f"softcap={cap}{' all but one masked' if one else ''}: max abs "
              f"{err:.3e} (bound {bound:.1e})", flush=True)
        check(err <= bound, "K5 differs from its plain version")
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
        err, ratio, eps, cmax = k7_case(B_, S_, H_, P_, N_, Q_, a_, shared,
                                        gen)
        k7_err = max(k7_err, err)
        print(f"[chip_smoke] K7 B={B_} S={S_} H={H_} P={P_} N={N_} Q={Q_} "
              f"A={'-linspace(1, 16)' if a_ is None else a_}"
              f"{' B/C head stride 0' if shared else ''}: max abs "
              f"{err:.3e}, worst error at {ratio:.3f} of its bound (bound "
              f"{eps:.2e} of the magnitude sum, max|cum| {cmax:.1f})",
              flush=True)
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
    k5t, k5lt, k6t = time_k5(K5_MAIN, gen), time_k5(K5_LONG, gen), \
        time_k6(gen)
    for label, t in (("K5", k5t), (f"K5 at C={K5_LONG[1]}", k5lt),
                     ("K6", k6t)):
        print(f"[chip_smoke] {label} at the serve path's shape: "
              f"{t['ms'] * 1e3:.2f} us/call, plain {t['plain_ms'] * 1e3:.2f} "
              f"us, library {t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bytes']} B)", flush=True)
    k6m = time_k6(gen, MAMBA["batch"], MAMBA_HEAD)
    print(f"[chip_smoke] K6 at mamba2's head (B={MAMBA['batch']}, "
          f"V={MAMBA_HEAD[0]}, v_real={MAMBA_HEAD[1]}, d={MAMBA_HEAD[2]}): "
          f"{k6m['ms'] * 1e3:.2f} us/call, plain {k6m['plain_ms'] * 1e3:.2f} "
          f"us, library {k6m['library_ms'] * 1e3:.2f} us, bound "
          f"{k6m['bound_ms'] * 1e3:.3f} us ({k6m['bytes']} B)", flush=True)
    k7t = time_k7(gen)
    print(f"[chip_smoke] K7 at the prefill's shape {K7_MAIN}: "
          f"{k7t['ms']:.3f} ms/launch, plain {k7t['plain_ms']:.3f} ms, "
          f"whole plain SSD (ssd_chunked) {k7t['chunked_ms']:.3f} ms, whole "
          f"K7 route (ops.ssd) {k7t['route_ms']:.3f} ms, library none, bound "
          f"{k7t['bound_ms']:.3f} ms (operations: {k7t['flops'] / 1e9:.2f} "
          f"GFLOP; bytes {k7t['bytes'] / 1e6:.1f} MB), achieved "
          f"{k7t['flops'] / k7t['ms'] / 1e9:.2f} TFLOP/s", flush=True)
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
    }]
    print(f"[chip_smoke] peak memory: savic {peak:.2f} GiB, savic int8 + EF "
          f"{cpeak:.2f} GiB, savic OASIS + participation 0.5 {rpeak:.2f} GiB, "
          f"serve {speak:.2f} GiB, long-prompt serve {lpeak:.2f} GiB, "
          f"mamba2 serve {mpeak:.2f} GiB", flush=True)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
