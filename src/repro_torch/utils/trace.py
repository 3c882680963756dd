"""Spans and counters of the port's training round, kept in memory.

    with trace.recording() as rec:       # off unless a caller opens this
        state, met = round_step(state, batch, stream)
    spans, counters = rec.collect()

``span(name)`` is a context manager at a layer boundary; ``count(name,
k)`` adds to a counter of the open round. Recording is off unless
``recording()`` is open: then ``span`` returns the one shared no-op
context ``OFF`` after a single module-level bool check, ``count`` returns
at once, and no autograd node is added, so the round's arithmetic and
memory are those of a program without spans.

A recorded span holds its name, id, parent id, native thread id
(``threading.get_native_id()``), start and end ns and round. Its parent is
the innermost span open on its own thread or, where that thread has none
open (autograd's device thread), the innermost open on the thread that
opened ``engine.round``. Its round is the number of ``engine.round`` spans
closed before it opened: a round's own spans and the batch made for it
share one. Times are ``time.time_ns()``, the clock of the profiler's
events: on an H100 host (torch 2.11, CUDA 12.8) the CUPTI launch events of
64 calls each lay between the ``time.time_ns()`` pair around its call,
which puts the trace's clock within [-2.6, 4.8] µs of it.

The program's counters: ``engine.grad_calls`` (each client gradient,
``core/engine``), ``engine.k1_launches`` (each K1 launch, ``kernels/ops``)
``model.ssd_k7`` (each SSD call that takes K7 and its VJP K7b,
``models/ssm.ssd_chunked``: forward and remat recompute alike), and the
expert share's ``model.moe_choices_held`` (the choices that land on a
held expert, counted once a layer call, not again in remat's recompute,
which routes from the forward's memo) and ``model.moe_host_reads`` (the
one host read of the held experts' counts a forward call,
``models/moe.share_apply``).

A model span follows its tensors into backward. ``sp.inputs(*ts)`` and
``sp.output(t)`` put an identity ``autograd.Function`` on the span's
floating inputs and on its output, so that backward opens ``<name>.bwd``
when the gradient reaches the output and closes it when it reaches the
inputs. A span opened while autograd runs backward is remat's forward run
again: it is recorded as ``<name>.recompute``, and its hooks return their
arguments.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch

ROUND = "engine.round"

_ON = False        # the one check a span makes while recording is off
_REC = None        # the open Recorder


class _Off:
    """The span of recording off: a no-op context whose hooks return their
    arguments."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, *ts):
        return ts

    def output(self, t):
        return t


OFF = _Off()


def span(name: str):
    if not _ON:
        return OFF
    return _Span(_REC, name)


def count(name: str, k: int = 1):
    if not _ON:
        return
    _REC.add(name, k)


@contextlib.contextmanager
def recording():
    """Record every span and counter while open; yields the ``Recorder``.
    Not reentrant."""
    global _ON, _REC
    if _ON:
        raise RuntimeError("trace.recording() is already open")
    _REC, _ON = Recorder(), True
    try:
        yield _REC
    finally:
        _ON, _REC = False, None


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    id: int
    parent: int         # 0: none
    thread: int         # threading.get_native_id() of the opening thread
    start_ns: int
    end_ns: int         # 0 while open
    round: int


class Recorder:
    """The spans and counters of one ``recording()``."""

    def __init__(self):
        self.spans = []
        self.counters = collections.defaultdict(collections.Counter)
        self.rounds = 0                  # engine.round spans closed
        self._ids = itertools.count(1)
        self._stacks = collections.defaultdict(list)   # thread -> open
        self._round_thread = None
        self._dangling = []              # .bwd spans opened, not closed
        self._lock = threading.Lock()

    def open(self, name: str) -> Span:
        th = threading.get_native_id()
        with self._lock:
            st = self._stacks[th]
            if not st and self._round_thread is not None:
                st = self._stacks[self._round_thread]
            if name == ROUND:
                self._round_thread = th
            sp = Span(name, next(self._ids), st[-1].id if st else 0, th,
                      time.time_ns(), 0, self.rounds)
            self.spans.append(sp)
            self._stacks[th].append(sp)
            if name.endswith(".bwd"):
                self._dangling.append(sp)
        return sp

    def close(self, sp: Span):
        with self._lock:
            sp.end_ns = time.time_ns()
            st = self._stacks[sp.thread]
            if sp in st:
                del st[st.index(sp):]
            if sp.name == ROUND:
                self.rounds += 1
                self._round_thread = None
            if sp.name.endswith(".bwd"):
                self._dangling.remove(sp)
            elif self._dangling and not sp.name.endswith(".recompute"):
                # a backward that never reached its span's inputs ends
                # with the forward span around that backward
                for d in [d for d in self._dangling
                          if d.start_ns >= sp.start_ns]:
                    d.end_ns = sp.end_ns
                    self._dangling.remove(d)
                    st = self._stacks[d.thread]
                    if d in st:
                        st.remove(d)

    def add(self, name: str, k: int):
        with self._lock:
            self.counters[self.rounds][name] += k

    def collect(self):
        """(spans in opening order, {round: {counter: value}})."""
        with self._lock:
            return list(self.spans), {r: dict(c)
                                      for r, c in self.counters.items()}


def _grad_tensors(ts):
    return [i for i, t in enumerate(ts) if isinstance(t, torch.Tensor)
            and t.requires_grad and t.is_floating_point()]


class _Bwd:
    """The ``.bwd`` span of one forward span, opened and closed from the
    backward of its identity hooks."""

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name, self.sp = rec, name, None

    def open(self):
        if self.sp is None:
            self.sp = self.rec.open(self.name)

    def close(self):
        if self.sp is not None and self.sp.end_ns == 0:
            self.rec.close(self.sp)


class _OpenAtOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bwd, x):
        ctx.bwd = bwd
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.bwd.open()
        return None, g


class _CloseAtInputs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bwd, *xs):
        ctx.bwd = bwd
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.bwd.close()
        return (None,) + gs


class _Span:
    """A recorded span: a context; ``inputs`` and ``output`` hook its
    tensors for its ``.bwd`` span."""
    __slots__ = ("rec", "name", "sp", "bwd")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.bwd = rec, None
        self.name = name + ".recompute" \
            if torch._C._current_graph_task_id() != -1 else name
        self.sp = None

    def __enter__(self):
        self.sp = self.rec.open(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.sp)
        return False

    def _hooks_on(self) -> bool:
        return torch.is_grad_enabled() and not self.name.endswith(
            ".recompute")

    def inputs(self, *ts):
        idx = _grad_tensors(ts) if self._hooks_on() else []
        if not idx:
            return ts
        self.bwd = _Bwd(self.rec, self.name + ".bwd")
        hooked = _CloseAtInputs.apply(self.bwd, *(ts[i] for i in idx))
        out = list(ts)
        for i, h in zip(idx, hooked):
            out[i] = h
        return tuple(out)

    def output(self, t):
        if self.bwd is None or not _grad_tensors([t]):
            return t
        return _OpenAtOutput.apply(self.bwd, t)


def self_ns(spans) -> dict:
    """Each span name's self time in ns, summed over its spans: a span's
    duration less the part of it that its children (on any thread)
    cover."""
    kids = collections.defaultdict(list)
    for sp in spans:
        kids[sp.parent].append(sp)
    out = collections.Counter()
    for sp in spans:
        covered, end = 0, sp.start_ns
        for s, e in sorted((max(k.start_ns, sp.start_ns),
                            min(k.end_ns, sp.end_ns)) for k in kids[sp.id]):
            s = max(s, end)
            if e > s:
                covered += e - s
                end = e
        out[sp.name] += sp.end_ns - sp.start_ns - covered
    return dict(out)
