"""The FLOP and byte counts against hand counts at the three cells' shapes.

qwen2-0.5b, a layer: q and o 896·896 each, k and v 896·2·64 each, the MLP
3·896·4864, so 14,909,440 matmul parameters, 24 layers plus the tied head
896·151,936: 493,961,216. Attention forward a token: 4·896·(S + 1)/2 a
layer. mamba2 at 24 layers, a layer: 2048·(2·4096 + 2·128 + 64) in,
4096·2048 out, (4096 + 256)·4 conv taps: 25,838,592; plus the head
2048·50,280: 723,099,648. SSD forward a token and layer at Q 256:
128·257 + 64·64·257 + 4·128·64·64 + 2·128·64·64/256 = 3,186,816.
n (the flat client state): 495,523,712 (qwen2) and 829,995,520 (mamba2,
24 layers), from the trees.
"""
from __future__ import annotations

import json
import os

import pytest

from perfbench import cells
from perfbench.counts import dense, savic, ssm

N = {"qwen2-0.5b": 495_523_712, "mamba2-1.3b.24of48": 829_995_520}
HAND = {
    # cell: (grad FLOPs a token, round FLOPs, K1 bytes a launch)
    "qwen2-0.5b.savic-adam.s1024":
        (6 * 493_961_216 + 3 * 24 * 4 * 896 * 1025 / 2,
         101_450_281_648_128, 4 * (5 * 4 + 1) * 495_523_712),
    "mamba2-1.3b.savic-adam.s2048":
        (6 * 723_099_648 + 3 * 24 * 3_186_816,
         74_842_908_917_760, 4 * (5 * 2 + 1) * 829_995_520),
    "qwen2-0.5b.savic-oasis-local.s512":
        (6 * 493_961_216 + 3 * 24 * 4 * 896 * 513 / 2,
         74_464_213_598_208, 4 * (8 * 4 * 495_523_712 + 2 * 4)),
}


def _json(*parts):
    with open(os.path.join(cells.HERE, *parts)) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", sorted(HAND))
def test_counts(cell):
    wl = _json("workloads", f"{cell}.json")
    config = _json("configs", f"{wl['config']}.json")
    job = _json("traffic", f"{wl['traffic']}.json")
    per_token, per_round, k1 = HAND[cell]
    fam = dense if config["family"] == "dense" else ssm
    got = fam.grad_flops_per_token(config, job["seq"])
    assert got == pytest.approx(per_token, rel=1e-12)
    assert savic.round_flops(job, got) == pytest.approx(per_round,
                                                        rel=1e-12)
    assert savic.k1_bytes(job, N[wl["config"]]) == k1


def test_matmul_params():
    assert dense.matmul_params(_json("configs", "qwen2-0.5b.json")) \
        == 493_961_216
    assert ssm.matmul_params(_json("configs", "mamba2-1.3b.24of48.json")) \
        == 723_099_648


@pytest.mark.parametrize("config", sorted(N))
def test_flat_size(config):
    """n as the counts take it: the size of the weights' spec, which is the
    program's tree."""
    import math
    from perfbench.reference import dense as rd, ssm as rs
    conf = _json("configs", f"{config}.json")
    spec = (rd if conf["family"] == "dense" else rs).param_spec(conf)
    assert sum(math.prod(s[1]) for s in spec) == N[config]
