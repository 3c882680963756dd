"""The port's span and counter recorder (``repro_torch/utils/trace.py``).

Recording off is one bool check: ``span`` hands out the shared no-op
``OFF``, records nothing and puts no node in the autograd graph. Recording
on nests spans by thread (a thread with none open hangs its spans under the
round's thread), follows a model span into backward (``.bwd``) and into
remat's second forward (``.recompute``), and leaves a SAVIC round's
arithmetic alone: losses, params, momentum and D bitwise equal to the
round recorded off, with M·H gradient calls and H K1 launches counted.
"""
from __future__ import annotations

import threading

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import ModelCallConfig, build
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

HOOKS = ("_OpenAtOutputBackward", "_CloseAtInputsBackward")


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _model_loss(arch, remat=True):
    cfg = get_config(arch, reduced=True)
    model = build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat))
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    return cfg, model, params, batch, leaves


def test_off_path():
    t = torch.ones(3, requires_grad=True)
    sp = trace.span("model.attention")
    assert sp is trace.OFF and trace.span("engine.round") is trace.OFF
    with sp as s:
        (u,) = s.inputs(t)
        assert u is t and s.output(t) is t
    trace.count("engine.grad_calls")
    _, model, params, batch, _ = _model_loss("qwen2-0.5b")
    off = _graph_names(model.loss(params, batch))
    assert not off & set(HOOKS)
    with trace.recording() as rec:
        on = _graph_names(model.loss(params, batch))
    assert set(HOOKS) <= on
    spans, counters = rec.collect()
    assert {sp.name for sp in spans} == {"model.attention",
                                         "model.loss_head"}
    # nothing recorded once recording is closed
    with trace.span("engine.round"):
        trace.count("engine.grad_calls")
    assert len(rec.collect()[0]) == len(spans) and counters == {}


def test_nesting_threads_collect():
    got = {}

    def worker(key, name):
        with trace.span(name) as s:
            with trace.span(name + ".inner") as inner:
                got[key] = (s.sp, inner.sp)

    with trace.recording() as rec:
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
        with trace.span("engine.round") as rnd:
            with trace.span("engine.grad") as grad:
                trace.count("engine.grad_calls", 3)
                th = threading.Thread(target=worker, args=("in", "bwd"))
                th.start()
                th.join(timeout=30)
                assert not th.is_alive()
        th = threading.Thread(target=worker, args=("after", "late"))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        trace.count("engine.k1_launches")
    spans, counters = rec.collect()
    assert [sp.name for sp in spans] == [
        "engine.round", "engine.grad", "bwd", "bwd.inner", "late",
        "late.inner"]
    outer, inner = got["in"]
    assert grad.sp.parent == rnd.sp.id and rnd.sp.parent == 0
    assert outer.parent == grad.sp.id and inner.parent == outer.id
    assert outer.thread != grad.sp.thread == threading.get_native_id()
    late, late_inner = got["after"]
    assert late.parent == 0 and late_inner.parent == late.id
    assert [sp.round for sp in spans] == [0, 0, 0, 0, 1, 1]
    assert all(sp.start_ns <= sp.end_ns for sp in spans)
    assert counters == {0: {"engine.grad_calls": 3},
                        1: {"engine.k1_launches": 1}}


@pytest.mark.parametrize("arch,name", [("qwen2-0.5b", "model.attention"),
                                       ("mamba2-1.3b", "model.ssd")])
def test_bwd_and_recompute(arch, name):
    cfg, model, params, batch, leaves = _model_loss(arch)
    with trace.recording() as rec:
        with trace.span("engine.grad"):
            torch.autograd.grad(model.loss(params, batch), leaves)
    spans, _ = rec.collect()
    by = lambda n: [sp for sp in spans if sp.name == n]
    fwd, rec_, bwd = by(name), by(name + ".recompute"), by(name + ".bwd")
    assert len(fwd) == len(rec_) == len(bwd) == cfg.n_layers
    head, head_bwd = by("model.loss_head"), by("model.loss_head.bwd")
    assert len(head) == len(head_bwd) == 1
    assert not by("model.loss_head.recompute")
    fwd_end = max(sp.end_ns for sp in fwd + head)
    assert all(sp.start_ns >= fwd_end for sp in bwd + rec_ + head_bwd)
    assert all(0 < sp.end_ns and sp.start_ns <= sp.end_ns for sp in spans)
    # backward runs the layers last to first: layer i's recompute, then
    # its .bwd, both after the loss head's .bwd
    order = [sp.name for sp in spans if sp.start_ns >= fwd_end]
    assert order[0] == "model.loss_head.bwd"
    assert order[1:] == [name + ".recompute", name + ".bwd"] * cfg.n_layers
    assert all(sp.parent == by("engine.grad")[0].id for sp in spans
               if sp.name != "engine.grad")


def test_bwd_that_never_reaches_inputs():
    """A ``.bwd`` whose inputs' gradient is not asked for ends with the
    forward span around its backward."""
    x = torch.ones(4, requires_grad=True)
    w = torch.full((4,), 2.0, requires_grad=True)
    with trace.recording() as rec:
        with trace.span("engine.grad"):
            with trace.span("model.ssd") as sp:
                (xi,) = sp.inputs(x)
                y = sp.output(xi * w)
            (g,) = torch.autograd.grad((3.0 * y).sum(), [w])
    spans = {sp.name: sp for sp in rec.collect()[0]}
    assert torch.equal(g, torch.full((4,), 3.0))
    assert spans["model.ssd.bwd"].end_ns == spans["engine.grad"].end_ns
    assert not rec._dangling


@pytest.mark.parametrize("arch,fused,oasis", [
    ("qwen2-0.5b", True, False), ("mamba2-1.3b", True, False),
    ("qwen2-0.5b", False, False), ("qwen2-0.5b", True, True)])
def test_round_bitwise_with_recording(arch, fused, oasis):
    """Recording on leaves the round bitwise as it is off: the fused and
    tree loops, and the local Hutchinson probe's double backward."""
    seq = "64" if arch.startswith("mamba2") else "32"
    run = train.setup(["--arch", arch, "--reduced", "--device", "cpu",
                       "--method", "savic", "--h-local", "2", "--clients",
                       "2", "--batch", "2", "--seq", seq, "--seed", "5"]
                      + ["--use-fused-kernel"] * fused
                      + ["--preconditioner", "oasis", "--scaling",
                         "local"] * oasis)
    state0 = run.state
    out = {}
    for on in (False, True):
        state = tree_map(torch.clone, state0)
        batch = train.round_batch(run.loader, run.args, 0, run.device)
        if on:
            with trace.recording() as rec:
                state, met = run.round_step(state, batch, run.stream(0))
        else:
            state, met = run.round_step(state, batch, run.stream(0))
        out[on] = (state, met)
    (s0, m0), (s1, m1) = out[False], out[True]
    for key in ("params", "mom", "precond"):
        a, b = dict(tree_paths(s0[key])), dict(tree_paths(s1[key]))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), key
    for key in ("loss", "loss_per_client", "client_drift"):
        assert torch.equal(m0[key], m1[key]), key
    spans, counters = rec.collect()
    names = [sp.name for sp in spans]
    assert counters == {0: {"engine.grad_calls": 4, "engine.k1_launches": 2}
                        if fused else {"engine.grad_calls": 4}}
    assert names.count("engine.grad") == 4
    assert names.count("engine.k1") == 2 * fused
    assert names.count("engine.update") == 4 * (not fused)
    assert names.count("engine.flatten") == 2 * fused
    assert names.count("engine.round") == names.count("engine.sync") == 1
    assert ("engine.precond" in names) != oasis
    assert names.count("engine.hvp") == 4 * oasis
    assert "engine.server" not in names
    model = "model.ssd" if arch.startswith("mamba2") else "model.attention"
    # a .bwd a layer a gradient, and another for each Hutchinson probe
    assert names.count(model + ".bwd") == 4 * 2 * (1 + oasis)


def test_self_ns():
    """A span's self time leaves out what its children cover, on any
    thread, overlaps counted once."""
    S = trace.Span
    spans = [S("engine.grad", 1, 0, 1, 0, 100, 0),
             S("model.attention", 2, 1, 1, 10, 30, 0),
             S("model.attention", 3, 1, 1, 20, 50, 0),
             S("model.attention.bwd", 4, 1, 2, 60, 70, 0),
             S("engine.k1", 5, 0, 1, 100, 104, 0)]
    assert trace.self_ns(spans) == {"engine.grad": 50, "model.attention": 50,
                                    "model.attention.bwd": 10,
                                    "engine.k1": 4}


def test_moe_spans_and_counters_in_a_round(monkeypatch):
    """A savic round of reduced nemotron3-nano-30b-a3b (3 expert layers,
    experts 2-5 of 8 held): ``model.moe`` and its two ``model.moe.route``
    spans a call nest under ``engine.grad``, forward, remat recompute and
    backward, and ``model.moe_choices_held`` is the count of the picks
    that land on a held expert, read off the routing of every forward call
    (one host read each); the recompute adds to neither. The round's
    arithmetic is the same with recording on."""
    from repro_torch import configs
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe
    import sys
    import types
    red = get_config("nemotron3-nano-30b-a3b", reduced=True)
    arch = "nemotron-trace-share"
    mod = types.ModuleType("repro_torch.configs.nemotron_trace_share")
    mod.CONFIG = mod.REDUCED = red.replace(name=arch, moe=MoEConfig(
        **{**red.moe.__dict__, "n_held": 4, "first_held": 2}))
    sys.modules[mod.__name__] = mod
    configs.register(arch, mod.__name__.rsplit(".", 1)[1])
    run = train.setup(["--arch", arch, "--device", "cpu", "--method",
                       "savic", "--h-local", "2", "--clients", "2",
                       "--batch", "2", "--seq", "32", "--seed", "5",
                       "--use-fused-kernel"])
    picks, real = [], moe.route_sigmoid

    def spy(p, c, x, given=None):
        out = real(p, c, x, given)
        if given is None:
            picks.append(out[0])
        return out
    monkeypatch.setattr(moe, "route_sigmoid", spy)
    batch = train.round_batch(run.loader, run.args, 0, run.device)
    s0, m0 = run.round_step(tree_map(torch.clone, run.state), batch,
                            run.stream(0))
    picks.clear()
    with trace.recording() as rec:
        s1, m1 = run.round_step(tree_map(torch.clone, run.state), batch,
                                run.stream(0))
    assert torch.equal(m0["loss"], m1["loss"])
    a, b = dict(tree_paths(s0["params"])), dict(tree_paths(s1["params"]))
    assert all(torch.equal(a[k], b[k]) for k in a)
    spans, counters = rec.collect()
    calls = 3 * 4                       # E layers × M·H
    assert len(picks) == calls
    held = sum(int(((p >= 2) & (p < 6)).sum()) for p in picks)
    assert 0 < held < sum(p.numel() for p in picks)
    assert counters[0]["model.moe_choices_held"] == held
    assert counters[0]["model.moe_host_reads"] == calls
    by_id = {sp.id: sp for sp in spans}

    def chain(sp):
        out = []
        while sp.parent:
            sp = by_id[sp.parent]
            out.append(sp.name)
        return out
    names = [sp.name for sp in spans]
    for suffix in ("", ".recompute", ".bwd"):
        assert names.count("model.moe" + suffix) == calls
        assert names.count("model.moe.route" + suffix) == 2 * calls
    for sp in spans:
        if sp.name.startswith("model.moe"):
            assert "engine.grad" in chain(sp), sp.name
        if sp.name.startswith("model.moe.route"):
            outer = "model.moe" + sp.name[len("model.moe.route"):]
            assert chain(sp)[0] == outer, (sp.name, chain(sp))
