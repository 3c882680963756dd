"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, started together), holds each against its plain
PyTorch version on the card, drives the port's paths through
``repro_torch.launch.train.main`` at the full width of qwen2-0.5b (the SAVIC
round; local-adam; SAVIC with int8-stochastic compression and error
feedback; SAVIC with OASIS and half the clients sampled), holds the fused
client loop against the tree loop, and checks what comes out. Any failed phase raises and
the script exits non-zero. Without a CUDA device, or without the rest of the
repository beside it, it exits non-zero before printing any result.

The second-to-last lines are one JSON object listing the kernels (launches on
the main path, error against the plain version, measured and least
possible times) and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import LMRoundLoader, TokenStream  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import quantize_update as qu  # noqa: E402
from repro_torch.kernels import scaled_update as su  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import ModelCallConfig  # noqa: E402
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.utils import rng  # noqa: E402
from repro_torch.utils.tree import tree_paths, tree_size  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
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


def main_argv(method, rounds, extra=()):
    return ["--arch", "qwen2-0.5b", "--method", method, "--use-fused-kernel",
            "--rounds", str(rounds), "--h-local", str(H_LOCAL), "--clients",
            "4", "--batch", "8", "--seq", "128", "--device", "cuda",
            *extra]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda f: f(), (su._lib, qu._lib)))
    for src in ("fused_step.cu", "quantize_update.cu"):
        info = build.BUILD_LOG.get(src, {"seconds": 0.0, "ptxas": "(cached)"})
        print(f"[chip_smoke] {src}: nvcc {info['seconds']:.2f} s\n"
              f"{info['ptxas']}", flush=True)
    print(f"[chip_smoke] built K1 and K3 in {time.perf_counter() - t0:.2f} s",
          flush=True)


def main():
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
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
    }]
    print(f"[chip_smoke] peak memory: savic {peak:.2f} GiB, savic int8 + EF "
          f"{cpeak:.2f} GiB, savic OASIS + participation 0.5 {rpeak:.2f} GiB",
          flush=True)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
