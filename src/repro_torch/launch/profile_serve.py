"""Where the time of a prefill and of a decode step goes on the GPU
(serving).

Builds the model and prompt as ``launch/serve.py::serve`` does, prefills the
decode cache (timed between device synchronizations), prefills once more
under ``torch.profiler``, runs ``--untraced`` greedy decode steps (each
timed between device synchronizations), then ``--traced`` more under the
profiler, and prints: the prefill time and the traced prefill's device time
split into K4 (flash attention, with ``--flash-kernel``), K7 (the SSD
intra-chunk term, with ``--ssd-kernel``: its prep and main kernels, two
launches a layer), GEMMs and the rest; the untraced
steps' wall times and their median, the device-busy time per traced step
(summed kernel time) as a share of the traced step and of the untraced
median, the device time and launches of K5 (decode attention: its split
pass and its merge, two launches a layer) and K6 (unembed + argmax; its
sliced kernel at heads wider than 2048) and the rest of a step's device
time, the kernels that took the most device time, the host ops that took
the most host time (self time), and the peak device
memory. CUDA only. The profiler's own cost inflates the host times and the
traced steps' wall time.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch qwen2-0.5b --full --decode-kernel --batch 8 --prompt-len 512
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch qwen2-0.5b --full --flash-kernel --decode-kernel --batch 2 \\
      --prompt-len 8192
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch mamba2-1.3b --full --ssd-kernel --decode-kernel --batch 4 \\
      --prompt-len 2048
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch zamba2-2.7b --full --ssd-kernel --flash-kernel \\
      --decode-kernel --batch 4 --prompt-len 2048
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch gemma3-4b --full --flash-kernel --decode-kernel --batch 2 \\
      --prompt-len 4096
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch qwen2-moe-a2.7b --full --flash-kernel --decode-kernel \\
      --batch 4 --prompt-len 2048

A hybrid (zamba2) prefill is split into K7 (its mamba layers), K4 (its
shared block's attention, one launch an application), GEMMs and the rest;
its decode step into K5 (one call an application), K6 and the rest. A MoE
(qwen2-moe) prefill's expert products are batched GEMMs, counted as GEMMs;
its routing's sort, scatter and gather kernels are listed apart
(``prefill_dispatch_kernels``) and stay in the rest.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.models import sample_batch, sample_ids
from repro_torch.utils import rng

# the port's kernels by the names of their CUDA functions
KERNELS = {"k5": ("decode_split", "decode_merge"),
           "k6": ("decode_sample_blocks", "decode_sample_sliced",
                  "decode_sample_reduce")}
PREFILL_KERNELS = {"k4": ("flash_attention_kernel",),
                   "k7": ("ssd_intra_chunk_prep", "ssd_intra_chunk_main")}
GEMM = ("gemm", "cutlass", "xmma")    # cuBLAS's kernels, by name (lower case)
# a MoE prefill's routing and dispatch: its sorts, the buffer's scatter, the
# combine's gather (by name, lower case); listed, inside "the rest"
DISPATCH = ("sort", "scatter", "gather", "index")
TOP = 12


def _device_events(prof):
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def _ms(events):
    return sum(e.self_device_time_total for e in events) / 1e3


def _tops(kernels, per, key):
    return [{"name": e.key[:90], "calls": e.count,
             key: e.self_device_time_total / 1e3 / per}
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
            [:TOP]]


def prefill_breakdown(prof):
    """Device time of a traced prefill: total, K4, K7, GEMMs, the rest (ms),
    K4 and K7 launches and the top kernels; and, listed apart (they stay in
    the rest), the kernels of a MoE layer's routing, dispatch and combine
    (sort, scatter, gather, index) with their sum."""
    kernels = _device_events(prof)
    out, ours = {}, []
    for name, fns in PREFILL_KERNELS.items():
        evs = [e for e in kernels if any(f in e.key for f in fns)]
        ours += evs
        out[f"prefill_{name}_ms"] = _ms(evs)
        out[f"prefill_{name}_launches"] = sum(e.count for e in evs)
    gemm = [e for e in kernels if e not in ours
            and any(f in e.key.lower() for f in GEMM)]
    total = _ms(kernels)
    dispatch = [e for e in kernels if e not in ours and e not in gemm
                and any(f in e.key.lower() for f in DISPATCH)]
    return {"prefill_device_ms": total, **out,
            "prefill_gemm_ms": _ms(gemm),
            "prefill_other_ms": total - _ms(ours) - _ms(gemm),
            "prefill_dispatch_ms": _ms(dispatch),
            "prefill_dispatch_kernels": _tops(dispatch, 1, "ms"),
            "prefill_top_kernels": _tops(kernels, 1, "ms")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--untraced", type=int, default=24)
    ap.add_argument("--traced", type=int, default=8)
    ap.add_argument("--decode-kernel", action="store_true")
    ap.add_argument("--flash-kernel", action="store_true")
    ap.add_argument("--ssd-kernel", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg, model, params, device = serve._setup(
        args.arch, reduced=not args.full, dtype=torch.float32,
        decode_window=0, use_decode_kernel=args.decode_kernel,
        use_flash_kernel=args.flash_kernel, use_ssd_kernel=args.ssd_kernel,
        seed=args.seed, device="cuda", params=None)
    B, S = args.batch, args.prompt_len
    steps = args.untraced + args.traced
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        prompt = sample_batch(cfg, rng.TorchStream(args.seed + 1), B, S,
                              device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_cache(params, prompt, S + steps + 1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            again = model.prefill_cache(params, prompt, S + steps + 1)
            torch.cuda.synchronize()
            traced_prefill_ms = (time.perf_counter() - t0) * 1e3
        del again
        prefill = prefill_breakdown(prof)
        head = model.sample_head(params) if args.decode_kernel else None
        noise = torch.zeros_like(logits)
        tok = sample_ids(logits, noise, cfg.vocab_size)
        untraced_ms = []
        for g in range(args.untraced):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = model.decode_sample(params, cache, tok, S + g,
                                             noise, head)
            torch.cuda.synchronize()
            untraced_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for g in range(args.untraced, steps):
                tok, cache = model.decode_sample(params, cache, tok, S + g,
                                                 noise, head)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / args.traced
    steady = sorted(untraced_ms[1:])
    median_ms = steady[len(steady) // 2]
    events = prof.key_averages()
    kernels = _device_events(prof)
    busy_ms = _ms(kernels) / args.traced
    ours = {}
    for name, fns in KERNELS.items():
        evs = [e for e in kernels if any(f in e.key for f in fns)]
        ours[f"{name}_ms_per_step"] = _ms(evs) / args.traced
        ours[f"{name}_launches"] = sum(e.count for e in evs)
    ours["other_ms_per_step"] = busy_ms - sum(
        ours[f"{name}_ms_per_step"] for name in KERNELS)
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)[:TOP]
    summary = {
        "device": torch.cuda.get_device_name(0), "batch": B,
        "prompt_len": S, "decode_kernel": args.decode_kernel,
        "flash_kernel": args.flash_kernel, "ssd_kernel": args.ssd_kernel,
        "prefill_ms": prefill_ms,
        "traced_prefill_ms": traced_prefill_ms, **prefill,
        "untraced_step_ms": untraced_ms,
        "untraced_step_median_ms": median_ms,
        "traced_step_ms": traced_ms, "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / traced_ms,
        "device_busy_share_untraced": busy_ms / median_ms,
        "tokens_per_s_untraced": B / median_ms * 1e3,
        **ours,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "top_kernels": _tops(kernels, args.traced, "ms_per_step"),
        "host_self_ms_per_step": sum(e.self_cpu_time_total for e in events
                                     if e.device_type.name == "CPU") / 1e3
        / args.traced,
        "top_host_ops": [{"name": e.key[:90], "calls": e.count,
                          "self_ms": e.self_cpu_time_total / 1e3}
                         for e in host],
    }
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
