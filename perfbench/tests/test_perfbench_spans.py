"""The span pass (``spans.py``) on synthetic events: a device operation is
put down to the innermost span open on its launching thread at its launch
(found by correlation id), or on the round's thread where that thread has
none open; subtree sums, idle gaps by span, coverage, and the counter
checks that drop a pass. On the CPU the pass runs with the program's
recorder and no profiler, and every reader of it returns None."""
from __future__ import annotations

import os
import sys

import pytest

from perfbench import cells, program, spans
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_reference import LIMITS  # noqa: F401

READERS = ("client_loop_dev_ms", "sync_dev_ms", "loss_head_dev_ms",
           "attn_dev_ms", "ssd_dev_ms", "device_idle_devonly_pct")
MAIN, AUTOGRAD = 10, 20


def _spans():
    from repro_torch.utils.trace import Span
    rows = [("engine.round", 1, 0, MAIN, 0, 1000),
            ("engine.local_steps", 2, 1, MAIN, 10, 800),
            ("engine.grad", 3, 2, MAIN, 20, 500),
            ("model.loss_head", 4, 3, MAIN, 30, 60),
            ("engine.k1", 5, 2, MAIN, 600, 650),
            ("engine.sync", 6, 1, MAIN, 810, 900),
            ("model.loss_head.bwd", 7, 3, AUTOGRAD, 100, 150)]
    return [Span(n, i, p, th, s, e, 0) for n, i, p, th, s, e in rows]


def _events(k1_thread=MAIN):
    launch = lambda corr, t, th: ("cudaLaunchKernel", t, t + 3, False, th,
                                  corr, False)
    kernel = lambda name, corr, s, t: (name, s, t, True, 7, corr, False)
    return [launch(1, 40, MAIN), kernel("gemm_a", 1, 45, 70),
            launch(2, 120, AUTOGRAD), kernel("gemm_b", 2, 125, 160),
            # no span open on the autograd thread: the round's thread's
            launch(3, 200, AUTOGRAD), kernel("mul", 3, 200, 260),
            launch(4, 610 if k1_thread == MAIN else 300, k1_thread),
            kernel("fused_step_vec4", 4, 615, 640),
            launch(5, 820, MAIN), kernel("copy", 5, 820, 850),
            kernel("no_launch", 6, 900, 910),
            launch(7, 950, MAIN), kernel("add", 7, 950, 960),
            # a module load on the launch's correlation id, and a kernel
            # that starts after the window
            ("Runtime Triggered Module Loading", 40, 41, False, 0, 1,
             False),
            kernel("late", 8, 1000, 1010)]


def _reduce(counters=None, **kw):
    counters = counters or {0: {"engine.grad_calls": 1,
                                "engine.k1_launches": 1}}
    return spans.reduce(_events(**kw), _spans(), counters, (0, 1000), 1,
                        grads=1, k1=1)


def test_attribution_and_sums():
    p = _reduce()
    assert p.read() and p.fault == ""
    assert p.dev_ns == {4: 25, 7: 35, 3: 60, 5: 25, 6: 30, 0: 10, 1: 10}
    ms = 1e-6
    assert p.under(["engine.local_steps"]) == pytest.approx(145 * ms)
    assert p.under(["engine.sync", "engine.precond",
                    "engine.server"]) == pytest.approx(30 * ms)
    assert p.under(["model.loss_head", "model.loss_head.bwd"]) == \
        pytest.approx(60 * ms)
    assert p.under(["model.attention"]) == 0
    assert p.busy_ns == 195 and p.window_ns == 1000
    assert p.idle_ns == {"engine.round": 125, "engine.grad": 450,
                         "engine.k1": 180, "engine.sync": 50}
    b = p.breakdown()
    assert b["span_coverage"] == pytest.approx(185 / 195)
    assert b["device_by_span"]["engine.grad"] == pytest.approx(60 * ms)
    assert b["device_by_span"]["host (no operation)"] == pytest.approx(
        10 * ms)
    assert list(b["idle_by_span"]) == ["engine.grad", "engine.k1",
                                       "engine.round", "engine.sync"]
    assert b["counters"] == {"engine.grad_calls": 1, "engine.k1_launches": 1}
    assert b["devonly_round_s"] == pytest.approx(1e-6)


@pytest.mark.parametrize("case", ["grad_calls", "grad_spans", "k1_count",
                                  "k1_elsewhere"])
def test_counter_checks_drop_the_pass(case):
    counters = {0: {"engine.grad_calls": 1, "engine.k1_launches": 1}}
    kw = {}
    if case == "grad_calls":
        counters[0]["engine.grad_calls"] = 2
    elif case == "k1_count":
        counters[0]["engine.k1_launches"] = 2
    elif case == "k1_elsewhere":
        kw["k1_thread"] = AUTOGRAD      # launched at 300, under engine.grad
    if case == "grad_spans":
        p = spans.reduce(_events(), _spans(), counters, (0, 1000), 1,
                         grads=2, k1=1)
    else:
        p = _reduce(counters, **kw)
    assert p.fault and not p.read()
    assert ("K1" in p.fault) == case.startswith("k1")


class _Ctx:
    rounds = 2

    def __init__(self, p=None):
        self.breakdown = {}
        if p is not None:
            self.program_spans = p


def _readers():
    cell = cells.load(os.path.dirname(cells.HERE),
                      "qwen2-0.5b.savic-adam.s1024")
    return {m: cell.reader(m) for m in READERS}


def test_readers_read_a_pass():
    readers = _readers()
    vals = {m: r.read(_Ctx(_reduce())) for m, r in readers.items()}
    assert vals["client_loop_dev_ms"] == pytest.approx(145e-6)
    assert vals["sync_dev_ms"] == pytest.approx(30e-6)
    assert vals["loss_head_dev_ms"] == pytest.approx(60e-6)
    assert vals["attn_dev_ms"] is None and vals["ssd_dev_ms"] is None
    assert vals["device_idle_devonly_pct"] == pytest.approx(80.5)
    faulty = _reduce({0: {"engine.grad_calls": 3, "engine.k1_launches": 1}})
    assert all(r.read(_Ctx(faulty)) is None for r in readers.values())


def test_cpu_pass_and_no_recorder(tmp_path, monkeypatch):
    """On the CPU the pass records the program's spans and counters but no
    device operation, so no reader reads it; a program without the
    recorder gives no pass."""
    tiny.register_archs()
    from repro_torch.utils import trace as recorder
    folder = tiny.checkout(str(tmp_path), LIMITS)
    cell = cells.load(str(tmp_path), "tiny-dense.adam", folder)
    prog = program.Program(cell, 11, "cpu")
    p = spans.run_pass(recorder, prog, 3)
    assert not p.device and p.fault == "" and not p.read()
    per_round = {"engine.grad_calls": 4, "engine.k1_launches": 2}
    assert p.counters == {0: per_round, 1: per_round}
    names = [sp.name for sp in p.spans.values()]
    assert names.count("engine.round") == 2
    assert names.count("data.round_batch") == 2
    assert names.count("model.attention.bwd") == 2 * 4 * 2
    assert all(r.read(_Ctx(p)) is None for r in _readers().values())
    # a harness frame holding the program: the pass runs from the reader
    ctx = _Ctx()
    n_first, rounds = 3, 1                       # noqa: F841 (read by `of`)
    assert spans.of(ctx) is ctx.program_spans is not None
    assert ctx.breakdown == {}
    import repro_torch.utils
    monkeypatch.delattr(repro_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)
    assert spans.of(_Ctx()) is None
    prog.free()

