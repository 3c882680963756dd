"""The program's spans against the device trace's clock, on the card
(``-m cuda``; skips without one):

    python -m pytest perfbench/tests/test_perfbench_spans_cuda.py -m cuda -s

One fused round of each cell's configuration at full width, recorded and
profiled as the span pass does (``spans.record``). Every launch of K1 lies
inside an ``engine.k1`` span with the spans' clock taken as the trace's,
and the pass reads (its counter checks hold). Then 64 small launches, each
between two ``time.time_ns()`` calls, bound the offset between the two
clocks: the trace's runtime event has to lie between its pair, which holds
for an offset in [-min(after), min(before)], printed with the margins of
the K1 launches in their spans.
"""
from __future__ import annotations

import gc
import os
from time import time_ns

import pytest
import torch

from perfbench import cells, program, spans

CELLS = ("qwen2-0.5b.savic-adam.s1024", "mamba2-1.3b.savic-adam.s2048")
PAIRS = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's rounds run on it)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_k1_launches_inside_their_spans(card, name):
    from repro_torch.utils import trace as recorder
    cell = cells.load(os.path.dirname(cells.HERE), name)
    torch.backends.cuda.matmul.allow_tf32 = cell.config["tf32"]
    prog = program.Program(cell, 2200000017, card)
    prog.step(prog.batch(0), 0)              # builds K1, warms every shape
    x = torch.zeros(1, device=card)
    pairs = []

    def calibrate():
        for _ in range(PAIRS):
            t0 = time_ns()
            x.add_(1.0)
            pairs.append((t0, time_ns()))
        torch.cuda.synchronize()

    events, sps, counters, window = spans.record(recorder, prog, 1, 1,
                                                 after=calibrate)
    job = cell.job
    p = spans.reduce(events, sps, counters, window, 1,
                     grads=job["clients"] * job["h_local"],
                     k1=job["h_local"])
    assert p.read(), p.fault
    k1_corr = {c for n, _, _, dev, _, c, _ in events
               if dev and any(k in n for k in spans.K1)}
    launches = [(s, t) for n, s, t, dev, _, c, _ in events
                if not dev and n.startswith("cu") and c in k1_corr]
    k1_spans = [sp for sp in sps if sp.name == "engine.k1"]
    assert len(launches) == len(k1_spans) == job["h_local"]
    margins = []
    for s, t in launches:
        inside = [sp for sp in k1_spans
                  if sp.start_ns <= s and t <= sp.end_ns]
        assert len(inside) == 1, (s, t, [(sp.start_ns, sp.end_ns)
                                         for sp in k1_spans])
        margins.append((s - inside[0].start_ns, inside[0].end_ns - t))
    calib = sorted((s, t) for n, s, t, dev, _, _, _ in events
                   if not dev and "LaunchKernel" in n and s >= window[1])
    assert len(calib) == PAIRS
    before = [s - t0 for (s, _), (t0, _) in zip(calib, pairs)]
    after = [t1 - t for (_, t), (_, t1) in zip(calib, pairs)]
    lo, hi = -min(after), min(before)
    print(f"\n[spans-cuda] {name}: {torch.cuda.get_device_name(0)}; trace "
          f"clock minus time.time_ns() in [{lo / 1e3:.3f}, {hi / 1e3:.3f}] "
          f"us over {PAIRS} launches; K1 launches (ns from their span's "
          f"start, to its end): {margins}; span coverage "
          f"{p.breakdown()['span_coverage']:.6f}", flush=True)
    assert lo <= hi
    prog.free()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
