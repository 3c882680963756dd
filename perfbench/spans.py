"""The program's own spans on the device trace's clock: a second traced
pass, after the traced rounds of ``trace.py``, which it leaves as they are.

The pass runs ``trace.TRACE_ROUNDS`` more rounds with the program's
recorder on (``repro_torch/utils/trace.py``: ``engine.*``, ``model.*``,
``data.round_batch`` spans and the ``engine.grad_calls`` and
``engine.k1_launches`` counters) under a profiler that records device
activity alone: kernels, copies, sets and CUPTI's runtime launch events,
and no host operation, so that the host runs the round at its own pace.
Spans are stamped with ``time.time_ns()``, the clock of those events.

Each device operation is put down to a span: its launch is the runtime
event with its correlation id; the span is the innermost one open on the
launching thread at the launch or, where that thread has none open
(autograd's device thread outside a ``.bwd`` span), the innermost open on
the round's thread, which waits inside ``engine.grad`` through backward.
Each idle gap between device operations is named by the innermost span
open at its start, over all threads. Nothing is written to disk.

A pass is read only where the spans agree with the counters: as many
``engine.grad`` spans as ``engine.grad_calls``, M·H a round, and as many
K1 kernels under ``engine.k1`` as ``engine.k1_launches``, H a round;
otherwise its metrics are left out and the reason goes to standard error.
A program without the recorder (``ImportError``) gives no pass, and its
readers nothing.

The harness hands its readers the traced window (``trace.Trace``) alone.
The first reader of a run to ask (``of``) runs the pass on the program
the harness's ``run`` holds, found on the calling frames, and keeps it on
the ``Trace``; it adds ``device_by_span``, ``idle_by_span``,
``span_coverage``, ``counters`` and ``devonly_round_s`` to its breakdown.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import time

import torch
from torch.autograd import DeviceType

from perfbench import program, trace

K1 = ("fused_step_vec4", "fused_step_scalar")
NO_SPAN = "host (no operation)"      # trace._host_in_flight's name


@dataclasses.dataclass
class Pass:
    rounds: int
    window_ns: int
    busy_ns: int
    device: bool           # device operations were traced
    spans: dict            # id -> the recorder's Span
    dev_ns: dict           # span id (0: none) -> device ns put down to it
    idle_ns: dict          # span name -> idle ns
    counters: dict         # round -> {counter: value}
    fault: str = ""        # why the pass is not read ("" where it is)

    def read(self) -> bool:
        return self.device and not self.fault

    def under(self, names) -> float:
        """Device ms a round put down to spans named ``names`` and their
        subtrees."""
        names = set(names)
        chains = {}

        def hit(i):
            if i not in chains:
                sp = self.spans.get(i)
                chains[i] = sp is not None and (
                    sp.name in names or hit(sp.parent))
            return chains[i]
        return sum(ns for i, ns in self.dev_ns.items() if i and hit(i)) \
            / 1e6 / self.rounds

    def breakdown(self) -> dict:
        by_name = collections.Counter()
        for i, ns in self.dev_ns.items():
            by_name[self.spans[i].name if i else NO_SPAN] += ns
        total = sum(self.dev_ns.values())
        ms = lambda c: {k: v / 1e6 / self.rounds for k, v in
                        sorted(c.items(), key=lambda kv: -kv[1])}
        first = min(self.counters) if self.counters else None
        return {"device_by_span": ms(by_name),
                "idle_by_span": ms(self.idle_ns),
                "span_coverage": (total - self.dev_ns.get(0, 0)) / total
                if total else None,
                "counters": self.counters.get(first, {}),
                "devonly_round_s": self.window_ns / 1e9 / self.rounds}


def of(ctx):
    """The pass of the traced run ``ctx``, run once; None where the
    program has no recorder or the harness holds no program."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = _run_for(ctx)
        p = ctx.program_spans
        if p is not None and p.fault:
            print(f"perfbench: the span pass is not read: {p.fault}",
                  file=sys.stderr)
        elif p is not None and p.device:
            ctx.breakdown.update(p.breakdown())
    return ctx.program_spans


def _run_for(ctx):
    try:
        from repro_torch.utils import trace as recorder
    except ImportError:
        print("perfbench: the program records no spans "
              "(no repro_torch.utils.trace)", file=sys.stderr)
        return None
    frame = sys._getframe(2)
    while frame is not None:
        loc = frame.f_locals
        prog = next((v for v in loc.values()
                     if isinstance(v, program.Program)
                     and v.state is not None), None)
        if prog is not None:
            r0 = loc.get("n_first", 0) + loc.get("rounds", 0) + ctx.rounds
            return run_pass(recorder, prog, r0)
        frame = frame.f_back
    return None


def run_pass(recorder, prog, r0: int, n: int = trace.TRACE_ROUNDS) -> Pass:
    """``n`` rounds of ``prog`` from ``r0`` with ``recorder`` on, under a
    device-only profiler where the program runs on a card."""
    job = prog.cell.job
    return reduce(*record(recorder, prog, r0, n), n,
                  grads=job["clients"] * job["h_local"], k1=job["h_local"])


def record(recorder, prog, r0: int, n: int, after=None):
    """(events, spans, counters, (start ns, end ns)) of ``n`` rounds of
    ``prog`` from ``r0``: the window opens with the first span (the first
    round's ``data.round_batch``) and closes when the device has ended
    the last round. ``after()``, where given, runs in the profile after
    the window."""
    on_card = prog.device.type == "cuda"
    trace._sync(prog.device)
    prof = contextlib.nullcontext()
    if on_card:
        prof = torch.autograd.profiler.profile(
            use_kineto=True, use_device="cuda", use_cpu=False)
        prof._parse_kineto_results = lambda *a, **k: []
    with recorder.recording() as rec:
        with prof:
            w0 = time.time_ns()
            for r in range(r0, r0 + n):
                batch = prog.batch(r)
                prog.step(batch, r)
                del batch
            trace._sync(prog.device)
            w1 = time.time_ns()
            if after is not None:
                after()
    spans, counters = rec.collect()
    events = [_event(e) for e in prof.kineto_results.events()] \
        if on_card else []
    return events, spans, counters, (min((sp.start_ns for sp in spans),
                                         default=w0), w1)


def _event(e):
    """(name, start ns, end ns, on the device, launching thread, correlation
    id, a span's device-side copy) of a raw profiler event; a runtime
    event's thread is its ``device_resource_id``."""
    s = e.start_ns()
    t = e.end_ns() if hasattr(e, "end_ns") else s + e.duration_ns()
    on_dev = e.device_type() == DeviceType.CUDA
    return (e.name(), s, t, on_dev, e.device_resource_id(),
            e.correlation_id(),
            bool(getattr(e, "is_user_annotation", lambda: False)()))


class _Innermost:
    """The innermost of one thread's spans open at times asked in
    increasing order (a thread's spans nest)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda sp: (sp.start_ns, sp.id))
        self.i, self.stack = 0, []

    def at(self, t: int):
        while self.i < len(self.spans) and self.spans[self.i].start_ns <= t:
            self.stack.append(self.spans[self.i])
            self.i += 1
        st = self.stack
        while st and st[-1].end_ns <= t:
            st.pop()
        return st[-1] if st else None


def reduce(events, spans, counters, window, rounds: int, grads: int,
           k1: int) -> Pass:
    """``events``: (name, start, end, on device, thread, correlation id,
    span copy); ``spans`` and ``counters`` the recorder's; ``grads`` and
    ``k1`` the counters' values a round."""
    w0, w1 = window
    spans = [dataclasses.replace(sp, end_ns=sp.end_ns or w1)
             for sp in spans]
    launches = {}
    dev = []
    for name, s, t, on_dev, th, corr, copy in events:
        if on_dev:
            if not copy and w0 <= s < w1:
                dev.append((s, min(t, w1), name, corr))
        elif name.startswith("cu"):
            launches[corr] = (s, th)
    round_th = next((sp.thread for sp in spans
                     if sp.name == "engine.round"), None)
    by_th = collections.defaultdict(list)
    for sp in spans:
        by_th[sp.thread].append(sp)
    sweeps = {th: _Innermost(v) for th, v in by_th.items()}
    dev_ns = collections.Counter()
    k1_under = 0
    for s, t, name, corr in sorted(
            dev, key=lambda d: launches.get(d[3], (d[0],))[0]):
        at = launches.get(corr)
        sp = None
        if at is not None:
            ls, th = at
            sp = sweeps[th].at(ls) if th in sweeps else None
            if sp is None and round_th is not None:
                sp = sweeps[round_th].at(ls)
        dev_ns[sp.id if sp is not None else 0] += t - s
        if sp is not None and sp.name == "engine.k1" and any(
                k in name for k in K1):
            k1_under += 1
    busy = trace._merge([(s, t) for s, t, _, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    idle = collections.Counter()
    host = [(sp.start_ns, sp.end_ns, sp.name, sp.thread) for sp in spans]
    for (s, t), name in zip(gaps, trace._host_in_flight(
            host, [g[0] for g in gaps])):
        idle[name] += t - s
    total = collections.Counter()
    for c in counters.values():
        total.update(c)
    n_grad = sum(sp.name == "engine.grad" for sp in spans)
    faults = []
    if not (n_grad == total["engine.grad_calls"] == grads * rounds):
        faults.append(f"{n_grad} engine.grad spans, engine.grad_calls "
                      f"{total['engine.grad_calls']}, M·H·rounds "
                      f"{grads * rounds}")
    if dev and not (k1_under == total["engine.k1_launches"] == k1 * rounds):
        faults.append(f"{k1_under} K1 kernels under engine.k1, "
                      f"engine.k1_launches {total['engine.k1_launches']}, "
                      f"H·rounds {k1 * rounds}")
    return Pass(rounds=rounds, window_ns=w1 - w0,
                busy_ns=sum(t - s for s, t in busy), device=bool(dev),
                spans={sp.id: sp for sp in spans}, dev_ns=dict(dev_ns),
                idle_ns=dict(idle), counters=counters,
                fault="; ".join(faults))
