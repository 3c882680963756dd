"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the port's
main path (the SAVIC round, ``repro_torch.launch.train.main``) at the full
width of qwen2-0.5b, and checks what comes out. Any failed phase raises and
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
from repro_torch.kernels import scaled_update as su  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import ModelCallConfig  # noqa: E402
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.utils.tree import tree_paths, tree_size  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
DEV = torch.device("cuda", 0)
H_LOCAL = 2
K1_N = 1 << 20                     # row length of the kernel-vs-plain cases
BIG = (3, 716_000_001)             # M, n of the launch with M·n > 2^31


def main_argv(method, rounds):
    return ["--arch", "qwen2-0.5b", "--method", method, "--use-fused-kernel",
            "--rounds", str(rounds), "--h-local", str(H_LOCAL), "--clients",
            "4", "--batch", "8", "--seq", "128", "--device", "cuda"]


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
# phases
# --------------------------------------------------------------------------- #


def main_path(argv, expect_launches):
    su.fused_step_flat.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log = train.main(argv)
    launches = su.fused_step_flat.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for rec in log:
        print(f"[chip_smoke]   round {rec['round']} loss {rec['loss']:.5f} "
              f"drift {rec['drift']:.4e} tokens/s {rec['tokens_per_s']} "
              f"wall {rec['wall_s']} s", flush=True)
        check(all(v == v and abs(v) != float("inf") for k, v in rec.items()
                  if isinstance(v, float)), f"non-finite record {rec}")
    check(launches == expect_launches,
          f"K1 launched {launches} times, expected {expect_launches}")
    print(f"[chip_smoke]   K1 launches {launches}, peak memory {peak:.2f} GiB",
          flush=True)
    return log, launches, peak


def fused_vs_tree():
    """One savic round at full width and 2 layers: fused client loop against
    the tree path from the same start, same batch."""
    cfg = get_config("qwen2-0.5b").replace(n_layers=2)
    model = build_model(cfg, ModelCallConfig(dtype=torch.float32))
    M, H, b, S = 4, 2, 8, 128
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=0), M, b)
    batch = {k: torch.from_numpy(v).to(DEV, torch.long)
             for k, v in loader.round_batch(0, H, S).items()}
    out = {}
    for fused in (True, False):
        spec = engine.method_spec("savic", gamma=3e-3,
                                  use_fused_kernel=fused)
        gen = torch.Generator(device=DEV).manual_seed(0)
        state = engine.init_state(gen, model.init, spec, M)
        state, met = engine.build_round_step(model.loss, spec)(state, batch)
        out[fused] = (state, float(met["loss"]))
    (sf, lf), (st, lt) = out[True], out[False]
    worst = 0.0
    for (k, a), (_, c) in zip(tree_paths(sf), tree_paths(st)):
        if a.is_floating_point():
            scale = float(c.abs().max()) or 1.0
            worst = max(worst, float((a - c).abs().max()) / scale)
        else:
            check(torch.equal(a, c), f"{k} differs")
    return lf, lt, worst


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] {smi_line()} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda}", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(0)

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    su._lib()
    info = build.BUILD_LOG.get("fused_step.cu", {"seconds": 0.0,
                                                 "ptxas": "(cached)"})
    print(f"[chip_smoke] built K1 in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s)\n{info['ptxas']}", flush=True)

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

    # ---- 3. main path: savic, full-width qwen2-0.5b ------------------------
    argv = main_argv("savic", 2)
    print("[chip_smoke] main path: train.main " + " ".join(argv), flush=True)
    log, launches, peak = main_path(argv, 2 * H_LOCAL)

    params = build_model(get_config("qwen2-0.5b")).init(
        torch.Generator(device=DEV).manual_seed(0))
    n_main = tree_size(params)          # per-client flat length n
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

    # ---- 5. fused against tree at full width, 2 layers ---------------------
    lf, lt, worst = fused_vs_tree()
    print(f"[chip_smoke] fused vs tree (savic, 2 layers): loss {lf:.6f} vs "
          f"{lt:.6f}, worst state diff {worst:.3e} of leaf scale", flush=True)
    check(abs(lf - lt) <= 1e-5 * abs(lt), "fused and tree losses differ")
    check(worst <= 1e-5, "fused and tree states differ beyond 1e-5")

    kernels = [{
        "name": "fused_step_flat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_step.cu",
        "replaces": "src/repro/kernels/scaled_update.py:201",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
