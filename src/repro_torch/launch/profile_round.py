"""Where one training round's time goes on the GPU.

Takes the training CLI's flags (``launch/train.py``), runs ``--rounds``
rounds untraced (each timed between device synchronizations), then one round
under ``torch.profiler`` with the program's spans recorded
(``utils/trace.py``) and prints: the untraced rounds' wall times and their
median after the first (the first carries the CUDA and cuBLAS set-up), the
traced round's wall time, the summed kernel time of the traced round, the
time and launches of the port's kernels (K1, the fused local step, and K3,
the int8 quantize-dequantize of compressed syncs), the kernels that took the
most device time, the host ops that took the most host time and each span's
host time (self time both, so nested ops and spans are not counted twice),
and the peak device memory over the whole run. CUDA only. The profiler's
own cost inflates the host times and the traced round's wall time; the
benchmark's ``perfbench/run.py --trace 1`` reads device time and idle
gaps by span from a device-only profile.

  PYTHONPATH=src python -m repro_torch.launch.profile_round \
      --arch qwen2-0.5b --method savic --use-fused-kernel --rounds 1 \
      --h-local 2 --clients 4 --batch 8 --seq 128
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import train
from repro_torch.utils import trace

# the port's kernels by the names of their CUDA functions
KERNELS = {"k1": ("fused_step_vec4", "fused_step_scalar"),
           "k3": ("quantize_update_vec4", "quantize_update_scalar")}
TOP = 15


def main(argv=None):
    run = train.setup(argv)
    args, device, state = run.args, run.device, run.state
    run.state = None
    if device.type != "cuda":
        raise RuntimeError("profile_round measures the GPU; run it with "
                           "--device cuda")
    torch.cuda.reset_peak_memory_stats()
    untraced_ms = []
    for r in range(args.rounds):
        batch = train.round_batch(run.loader, args, r, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = run.round_step(state, batch, run.stream(r))
        float(met["loss"])
        torch.cuda.synchronize()
        untraced_ms.append((time.perf_counter() - t0) * 1e3)
    # round 0 carries the process's CUDA and cuBLAS set-up
    steady = sorted(untraced_ms[1:])
    steady_ms = steady[len(steady) // 2] if steady else None
    batch = train.round_batch(run.loader, args, args.rounds, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            trace.recording() as rec:
        t0 = time.perf_counter()
        state, met = run.round_step(state, batch, run.stream(args.rounds))
        float(met["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    span_self = trace.self_ns(rec.collect()[0])
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {}
    for name, fns in KERNELS.items():
        evs = [e for e in kernels if any(f in e.key for f in fns)]
        ours[f"{name}_ms"] = sum(e.self_device_time_total for e in evs) / 1e3
        ours[f"{name}_launches"] = sum(e.count for e in evs)
    tops = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)[:TOP]
    summary = {
        "device": torch.cuda.get_device_name(0), "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "untraced_round_ms": untraced_ms,
        "untraced_steady_median_ms": steady_ms, **ours,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": e.self_device_time_total / 1e3}
                        for e in tops],
        "host_self_ms": sum(e.self_cpu_time_total for e in events
                            if e.device_type.name == "CPU") / 1e3,
        "top_host_ops": [{"name": e.key[:90], "calls": e.count,
                          "self_ms": e.self_cpu_time_total / 1e3}
                         for e in host],
        "span_host_self_ms": {k: v / 1e6 for k, v in sorted(
            span_self.items(), key=lambda kv: -kv[1])},
    }
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
