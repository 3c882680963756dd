"""K7's count of work and its launch plan (``kernels/ssd_scan.py``), in pure
Python: no card needed.

``work`` gives every K7 bound (``chip_smoke.py`` imports it); ``plan`` decides
the C·Bᵀ groups and the grids the wrapper launches, and ``prep_block`` /
``main_block`` decode a block index as the kernels do. The grids must cover
every causal G tile of every (batch, chunk, group) and every (batch, chunk,
row tile, head) exactly once.
"""
import dataclasses
from collections import Counter

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm

K7_MAIN = (4, 2048, 64, 64, 128, 256)     # B, S, H, P, N, Q of the prefill
ONE_CHUNK = (1, 256, 64, 64, 128, 256)    # the continuous-batching prefill
RAGGED = (1, 144, 3, 30, 20, 48)


@pytest.mark.parametrize("shape,groups,flops,nbytes", [
    (K7_MAIN, 1, 17_482_907_648, 346_038_528),
    (K7_MAIN, 64, 34_460_401_664, None),
    (ONE_CHUNK, 1, 546_340_864, None),
])
def test_work_exact(shape, groups, flops, nbytes):
    f, b = ssd.work(*shape, groups)
    assert f == flops
    if nbytes is not None:
        assert b == nbytes


def test_work_bounds_at_the_fp32_peak():
    """The bounds PERF.md quotes: 0.2609 ms at the prefill's shape (one
    group), 0.5143 ms counted per head, 8.15 µs for one chunk."""
    peak = 67e12
    assert ssd.work(*K7_MAIN, 1)[0] / peak * 1e3 == pytest.approx(0.2609,
                                                                   abs=5e-5)
    assert ssd.work(*K7_MAIN, 64)[0] / peak * 1e3 == pytest.approx(0.5143,
                                                                   abs=5e-5)
    assert ssd.work(*ONE_CHUNK, 1)[0] / peak * 1e6 == pytest.approx(8.15,
                                                                    abs=5e-3)


def _bc(B, S, H, N, kind):
    """B/C views: "heads" the model's ``_heads`` view of one group,
    "expand" an expanded (B, S, 1, N), "full" a contiguous per-head
    tensor, "strided" a per-head view with other strides."""
    if kind == "heads":
        s = dataclasses.replace(get_config("mamba2-1.3b", reduced=True).ssm,
                                d_state=N, ngroups=1)
        return ssm._heads(torch.zeros(B, S, N), s, H)
    if kind == "expand":
        return torch.zeros(B, S, 1, N).expand(B, S, H, N)
    if kind == "full":
        return torch.zeros(B, S, H, N)
    return torch.zeros(B, H, S, 2 * N).transpose(1, 2)[..., ::2]


@pytest.mark.parametrize("kb,kc,groups", [
    ("heads", "heads", 1), ("expand", "expand", 1), ("heads", "expand", 1),
    ("full", "full", 8), ("expand", "full", 8), ("full", "expand", 8),
    ("heads", "strided", 8), ("strided", "heads", 8),
    ("strided", "strided", 8),
])
def test_plan_groups(kb, kc, groups):
    """One group only when both B and C have head stride 0; a head-stride-0
    B beside a per-head C (or the other way round) is per head."""
    B, S, H, N = 2, 16, 8, 12
    Bm, Cm = _bc(B, S, H, N, kb), _bc(B, S, H, N, kc)
    assert Bm.shape == Cm.shape == (B, S, H, N)
    p = ssd.plan(B, S, H, 16, N, 8, Bm.stride(), Cm.stride())
    assert p.groups == groups
    assert p.g_blocks == B * (S // 8) * groups * p.npairs


def test_heads_view_plans_one_group():
    """The model's own B/C (``_heads`` of one group) at mamba2-1.3b's
    widths give one G group."""
    s, _, H = ssm._dims(get_config("mamba2-1.3b", reduced=False))
    Bm = ssm._heads(torch.zeros(1, 4, s.ngroups * s.d_state), s, H)
    Cm = ssm._heads(torch.zeros(1, 4, s.ngroups * s.d_state), s, H)
    p = ssd.plan(1, 256, H, s.head_dim, s.d_state, s.chunk, Bm.stride(),
                 Cm.stride())
    assert (s.ngroups, H, p.groups) == (1, 64, 1)


@pytest.mark.parametrize("shape,groups", [
    (K7_MAIN, 1), (K7_MAIN, 64), (ONE_CHUNK, 1), (RAGGED, 1), (RAGGED, 3),
])
def test_grids_cover_every_tile_once(shape, groups):
    B, S, H, P, N, Q = shape
    hs = 0 if groups == 1 else N
    p = ssd.plan(B, S, H, P, N, Q, (0, 0, hs, 1), (0, 0, hs, 1))
    assert p.groups == groups
    nc = S // Q
    # prep: every causal G tile of every (b, c, group) once, every cell's
    # cum once
    tiles, cells = Counter(), Counter()
    for blk in range(p.prep_grid):
        kind, *rest = ssd.prep_block(p, blk)
        if kind == "g":
            tiles[tuple(rest)] += 1
        else:
            cells.update(rest[0])
    want = {(b, c, g, i, j) for b in range(B) for c in range(nc)
            for g in range(groups) for i in range(p.nrt)
            for j in range(i + 1)}
    assert set(tiles) == want and set(tiles.values()) == {1}
    assert set(cells) == set(range(p.cells)) and set(cells.values()) == {1}
    # main: every (b, c, row tile, head) once, every (b, c, N tile, head) once
    ys, states = Counter(), Counter()
    for blk in range(p.main_grid):
        kind, b, c, h, tile = ssd.main_block(p, blk)
        (ys if kind == "y" else states)[(b, c, tile, h)] += 1
    cover = lambda ntiles: {(b, c, t, h) for b in range(B) for c in range(nc)
                            for t in range(ntiles) for h in range(H)}
    assert set(ys) == cover(p.nrt) and set(ys.values()) == {1}
    assert set(states) == cover(p.nst) and set(states.values()) == {1}
    # a (batch, chunk)'s blocks run together, the heaviest first: the last
    # row tile and the state blocks lead, each over all heads
    per_chunk = H * (p.nrt + p.nst)
    for blk in range(p.main_grid):
        kind, b, c, h, tile = ssd.main_block(p, blk)
        assert blk // per_chunk == b * nc + c and blk % H == h
    first = {ssd.main_block(p, blk)[0::4] for blk in range(H * (1 + p.nst))}
    assert first == {("y", p.nrt - 1)} | {("state", t) for t in range(p.nst)}


def test_plan_at_the_prefill_shape():
    p = ssd.plan(*K7_MAIN, (0, 0, 0, 1), (0, 0, 0, 1))
    assert (p.groups, p.hg, p.pd, p.nrt, p.nst) == (1, 1, 64, 4, 2)
    assert (p.g_blocks, p.prep_grid, p.main_grid) == (320, 576, 12288)
    assert p.g_shape == (4, 8, 1, 16, 64, 64)
    assert p.cell_shape == (4, 8, 64, 3, 256)
    assert p.scratch_bytes == {"g": 8_388_608, "cell": 6_291_456}


@pytest.mark.parametrize("P,pd", [(1, 32), (30, 32), (32, 32), (33, 64),
                                  (64, 64), (65, 128), (128, 128)])
def test_plan_pads_p(P, pd):
    assert ssd.plan(1, 64, 2, P, 16, 64, (0, 0, 0, 1),
                    (0, 0, 0, 1)).pd == pd
