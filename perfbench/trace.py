"""The traced window: ``TRACE_ROUNDS`` whole rounds under the profiler,
reduced in memory to what the per-layer readers take (nothing is written
to disk). They follow the run's untraced window, whose time a round the
harness hands to the readers beside them (``round_s``).

The harness's own spans (``perfbench.window``, ``perfbench.batch``,
``perfbench.round``) mark the calls into the program: the program has
none of its own.

The reduction reads the profiler's raw events (the per-event objects that
``prof.events()`` would build take minutes for a round's ~10^5 kernels),
and keeps: the device operations that start in the window (kernels,
copies, sets; not the spans' device-side copies), their busy time as the
union of their intervals (not a sum of their times), the idle gaps
between them, each named by the innermost host operation in flight when
it opened, and the harness's host spans.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function

TOP = 10
TRACE_ROUNDS = 2     # the same in every cell
SPANS = ("perfbench.window", "perfbench.batch", "perfbench.round")


@dataclasses.dataclass
class Trace:
    rounds: int            # traced rounds
    window_s: float
    busy_s: float
    kernels: list          # (name, seconds) of each device operation
    spans: dict            # harness span -> host seconds of each call
    breakdown: dict        # device_ops, idle_gaps: [[name, seconds], ...]
    cell: dict = None      # the cell's counts, for the readers
    round_s: float = None  # wall seconds a round of the untraced window


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def traced_rounds(prog, r0: int, n: int = TRACE_ROUNDS) -> Trace:
    """n rounds from r0 under the profiler."""
    _sync(prog.device)
    spans = collections.defaultdict(list)
    prof = torch.autograd.profiler.profile(
        use_kineto=True,
        use_device="cuda" if prog.device.type == "cuda" else None)
    # the raw events are read below; the profiler's own parse is not needed
    prof._parse_kineto_results = lambda *a, **k: []
    with prof:
        with record_function("perfbench.window"):
            for r in range(r0, r0 + n):
                t = time.perf_counter()
                with record_function("perfbench.batch"):
                    batch = prog.batch(r)
                spans["batch"].append(time.perf_counter() - t)
                with record_function("perfbench.round"):
                    prog.step(batch, r)
                del batch
            _sync(prog.device)
    events = [_event(e) for e in prof.kineto_results.events()]
    return reduce(events, n, dict(spans))


def _event(e):
    """(name, start ns, end ns, on the device, host thread, a span's
    device-side copy) of a raw profiler event."""
    s = e.start_ns()
    t = e.end_ns() if hasattr(e, "end_ns") else s + e.duration_ns()
    return (e.name(), s, t, e.device_type() == DeviceType.CUDA,
            e.start_thread_id(),
            bool(getattr(e, "is_user_annotation", lambda: False)())
            or e.name() in SPANS)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_in_flight(cpu, points):
    """For each time in ``points`` (sorted), the name of the innermost host
    operation open then, over every host thread (the latest started), or
    "host (no operation)"."""
    cpu = sorted(cpu)
    stacks = collections.defaultdict(list)
    i, names = 0, []
    for g in points:
        while i < len(cpu) and cpu[i][0] <= g:
            s, e, name, th = cpu[i]
            st = stacks[th]
            while st and st[-1][1] <= s:
                st.pop()
            st.append((s, e, name))
            i += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] <= g:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        names.append(best[2] if best else "host (no operation)")
    return names


def reduce(events, rounds: int, spans: dict) -> Trace:
    """``events``: (name, start ns, end ns, on device, thread, span copy)."""
    w0, w1 = next((s, t) for name, s, t, dev, _, _ in events
                  if name == "perfbench.window" and not dev)
    dev, cpu = [], []
    for name, s, t, on_dev, th, copy in events:
        if on_dev:
            if not copy and w0 <= s < w1:
                dev.append((s, min(t, w1), name))
        elif name != "perfbench.window":
            cpu.append((s, t, name, th))
    busy = _merge([(s, t) for s, t, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    by_gap = collections.Counter()
    for (s, t), name in zip(gaps, _host_in_flight(cpu, [g[0]
                                                        for g in gaps])):
        by_gap[name] += (t - s) / 1e9
    by_op = collections.Counter()
    for s, t, name in dev:
        by_op[name[:160]] += (t - s) / 1e9
    return Trace(
        rounds=rounds, window_s=(w1 - w0) / 1e9,
        busy_s=sum(t - s for s, t in busy) / 1e9,
        kernels=[(name, (t - s) / 1e9) for s, t, name in dev], spans=spans,
        breakdown={"device_ops": [[k, v] for k, v in by_op.most_common(TOP)],
                   "idle_gaps": [[k, v] for k, v in
                                 by_gap.most_common(TOP)]})
