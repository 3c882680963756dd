"""The check fails what it has to fail. A whole run of the harness on the
CPU, past its look for a card, with the timed path broken underneath,
comes out not correct for each fault a training cell on one card can
have: a round that returns its state unchanged, half of each microbatch
left out with the mean taken over the rest, and a token altered where the
batch is made. The control, the reference computed in TF32 in the
program's place, fails too (emulated on the CPU; on the card, marked
``cuda``, in TF32 itself)."""
from __future__ import annotations

import os
import time

import pytest
import torch

from perfbench import cells, check, control, harness
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_reference import LIMITS, root  # noqa

FAULT_CELLS = sorted(tiny.CELLS)


def _cell(root, name):
    return cells.load(root, name, os.path.join(root, "perfbench"))


def _run(root, name):
    result, _ = harness.run(_cell(root, name), 5, 0.0, False, "cpu",
                            time.perf_counter())
    return result


def _unchanged(build):
    def wrapped(loss_fn, spec, **kw):
        step = build(loss_fn, spec, **kw)

        def round_step(state, batch, stream=None):
            _, met = step(state, batch, stream)
            return state, met
        return round_step
    return wrapped


def _half_batch(build):
    def wrapped(loss_fn, spec, **kw):
        def half(params, micro, *a, **k):
            keep = {key: v[: max(v.shape[0] // 2, 1)]
                    for key, v in micro.items()}
            return loss_fn(params, keep, *a, **k)
        return build(half, spec, **kw)
    return wrapped


def _token(round_batch):
    def wrapped(loader, args, r, device):
        batch = round_batch(loader, args, r, device)
        tok = batch["tokens"].clone()
        S = tok.shape[-1]
        tok[0, 0, 0, S // 2] = (tok[0, 0, 0, S // 2] + 1) % args.seq
        return {**batch, "tokens": tok}
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
@pytest.mark.parametrize("name", FAULT_CELLS)
def test_fault_fails(root, name, fault, monkeypatch):  # noqa: F811
    from repro_torch.core import engine
    from repro_torch.launch import train
    if fault == "token":
        monkeypatch.setattr(train, "round_batch", _token(train.round_batch))
    else:
        wrap = _unchanged if fault == "unchanged" else _half_batch
        monkeypatch.setattr(engine, "build_round_step",
                            wrap(engine.build_round_step))
    result = _run(root, name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", FAULT_CELLS)
def test_control_fails_on_cpu(root, name):  # noqa: F811
    cell = _cell(root, name)
    ref = harness.reference_rounds(cell, 7, "cpu")
    ctl = harness.reference_rounds(cell, 7, "cpu", ein=control.tf32_einsum)
    ok, checks = check.judge(check.readings(ctl, ref), LIMITS)
    assert not ok, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 runs on the "
                    "card only")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAULT_CELLS)
def test_control_fails_on_card(root, name, card):  # noqa: F811
    cell = _cell(root, name)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = harness.reference_rounds(cell, 7, card)
    with control.tf32_on():
        ctl = harness.reference_rounds(cell, 7, card)
    ok, checks = check.judge(check.readings(ctl, ref), LIMITS)
    assert not ok, checks
