"""The nemotron_h family (Nemotron-3-Nano-30B-A3B's hybrid stack) against the
benchmark's plain reference (``perfbench/reference/nemotron_h.py``) on the
CPU, at the reduced size, on the reference's seeded weights: each layer
kind alone (M at 8 heads in 2 groups with the grouped gate norm and the
conv bias; E holding 4 of 8 experts; * without positions) and the whole
pattern stack, on loss and every gradient.

The expert share: two shares of 4 experts and the shared expert counted
once add up to the uncut layer of 8; a routing skewed onto the held
experts drops no choice (``model.moe_choices_held`` = N·K); remat's
recompute routes from the forward's memo. The configs: the published
count (31.6 B), the benchmark's cut (956,058,112 = the reference's spec),
the registry. The benchmark's counts against a hand count, and a whole
run of a tiny cell of the family through the harness. The card test
holds K7 + K7b at 8 groups and Q 128 on the training route against the
plain VJP and against the plain chunked scan.

Tolerances: fp32 on both sides, summed in other orders (einsum against
matmul, the SSD's chunked form against K7's plain version, the held
experts' rows gathered against masked): 2e-6 relative on the loss, 1e-5
of each leaf's largest gradient.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import types

import pytest
import torch

from perfbench.counts import nemotron_h as counts
from perfbench.reference import nemotron_h as ref
from perfbench.reference import weights
from repro_torch import configs
from repro_torch.configs import MoEConfig
from repro_torch.models import ModelCallConfig, build, moe
from repro_torch.models.layers import mlp, padded_vocab
from repro_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_CONFIG = os.path.join(ROOT, "perfbench", "configs",
                            "nemotron3-nano-30b-a3b.13of52.ep16.json")
RED = configs.get_config("nemotron3-nano-30b-a3b", reduced=True)


def share(cfg, n_held, first=0):
    return cfg.replace(moe=MoEConfig(**{**cfg.moe.__dict__,
                                        "n_held": n_held,
                                        "first_held": first}))


def ref_config(cfg):
    """The reference's configuration dict of a program config."""
    m = cfg.moe
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "vocab_size": cfg.vocab_size,
            "padded_vocab": padded_vocab(cfg.vocab_size),
            "norm_eps": cfg.norm_eps,
            "hybrid_override_pattern": cfg.layer_pattern,
            "ssm": dataclasses.asdict(cfg.ssm),
            "n_experts": m.n_held or m.n_experts, "first_expert": m.first_held,
            "n_routed_experts": m.n_experts, "num_experts_per_tok": m.top_k,
            "moe_intermediate_size": m.d_ff_expert,
            "moe_shared_expert_intermediate_size": m.d_ff_shared,
            "routed_scaling_factor": m.routed_scale}


def batch(cfg, seed=1, b=2, S=32):
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (b, S + 1), generator=gen)
    return tok[:, :-1], tok[:, 1:]


def both(cfg, seed=7, remat=True):
    """(program loss, its grads by path, reference loss, its grads) on the
    reference's weights of ``seed``."""
    rc = ref_config(cfg)
    spec = ref.param_spec(rc)
    tok, lab = batch(cfg)
    out = []
    for side in ("program", "reference"):
        params = weights.make(spec, seed, "cpu")
        leaves = weights.paths(params)
        for _, v in leaves:
            v.requires_grad_(True)
        if side == "program":
            model = build(cfg, ModelCallConfig(dtype=torch.float32,
                                               remat=remat))
            loss = model.loss(params, {"tokens": tok, "labels": lab})
        else:
            loss = ref.loss(params, tok, lab, rc)
        gs = torch.autograd.grad(loss, [v for _, v in leaves],
                                 allow_unused=True)
        out += [float(loss.detach()),
                {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves, gs)}]
    return out


def assert_close(cfg, **kw):
    lp, gp, lr, gr = both(cfg, **kw)
    assert lp == pytest.approx(lr, rel=2e-6, abs=0)
    assert gp.keys() == gr.keys()
    for k in gr:
        tol = 1e-5 * max(float(gr[k].abs().max()), 1e-30)
        assert float((gp[k] - gr[k]).abs().max()) <= tol, k
    return gp, gr


@pytest.mark.parametrize("kind", ["M", "E", "*"])
def test_layer_kind_alone(kind):
    """One layer of each kind, on loss and gradients: M at 8 heads, 2
    groups of B/C, the gate norm over 2 groups, a conv bias; E holding
    experts 2-5 of 8; * with no position (the reference has none)."""
    cfg = RED.replace(n_layers=1, layer_pattern=kind)
    if kind == "E":
        cfg = share(cfg, 4, 2)
    gp, gr = assert_close(cfg)
    if kind == "M":
        assert float(gp[("blocks", "mamba", "mamba", "conv_x_b")].abs()
                     .max()) > 0
    if kind == "E":
        bias = ("blocks", "moe", "moe", "score_bias")
        assert not gp[bias].any() and not gr[bias].any()


def test_attention_has_no_positions():
    """With ``rope`` off the attention layer is the one the reference
    computes; with it on (the program's default) it is not."""
    cfg = RED.replace(n_layers=1, layer_pattern="*")
    wq = ("blocks", "attention", "attn", "wq", "w")
    _, gp, _, gr = both(cfg.replace(rope=True))
    assert float((gp[wq] - gr[wq]).abs().max()) \
        > 1e-2 * float(gr[wq].abs().max())


@pytest.mark.parametrize("held", [(0, 0), (4, 4)])
def test_pattern_stack(held):
    """The reduced stack, MEMEM*E, whole (all 8 experts held) and holding
    experts 4-7."""
    assert_close(share(RED, *held))


def test_shares_add_up_to_the_uncut_layer():
    """E = 8 in two shares of 4: the shares' routed parts, plus the shared
    expert counted once, give the uncut layer (and the reference's)."""
    gen = torch.Generator().manual_seed(3)
    full = share(RED, 8)
    p = moe.init_share(gen, full)
    x = torch.randn(2, 16, RED.d_model, generator=gen)
    y_full = moe.share_apply(p, full, x, torch.float32)
    parts = []
    for first in (0, 4):
        q = dict(p, experts={k: v[first:first + 4]
                             for k, v in p["experts"].items()})
        parts.append(moe.share_apply(q, share(RED, 4, first), x,
                                     torch.float32))
    shared = mlp(p["shared"], x.reshape(-1, RED.d_model), "relu2",
                 torch.float32).reshape(x.shape)
    torch.testing.assert_close(parts[0] + parts[1] - shared, y_full,
                               rtol=0, atol=1e-5)
    lp = {"norm1": {"scale": torch.ones(RED.d_model)}, "moe": p}
    # the reference's layer adds x after its own RMSNorm of x: hand it the
    # normed x through a unit scale and compare the mixer's part
    u = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + RED.norm_eps)
    want = ref._moe(x, lp, ref_config(full), torch.einsum) - x
    got = moe.share_apply(p, full, u, torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("skew", ["held", "one"])
def test_skewed_routing_drops_nothing(skew):
    """A correction bias that sends every token to held experts ("held":
    the top 3 are experts 0-2 of the 4 held) or every token's first pick
    to expert 0 ("one": N choices on one expert, past any capacity): every
    held choice is computed (the counter is the routing's count) and the
    output is the reference's."""
    cfg = share(RED, 4, 0)
    rc = ref_config(cfg)
    gen = torch.Generator().manual_seed(5)
    p = moe.init_share(gen, cfg)
    bias = torch.zeros(8)
    bias[:3 if skew == "held" else 1] = torch.tensor([30.0, 20.0, 10.0][
        :3 if skew == "held" else 1])
    p["score_bias"] = bias
    x = torch.randn(2, 32, RED.d_model, generator=gen)
    with trace.recording() as rec:
        got = moe.share_apply(p, cfg, x, torch.float32)
    counters = rec.collect()[1][0]
    picks, _ = moe.route_sigmoid(p, cfg, x.reshape(-1, RED.d_model))
    held = int((picks < 4).sum())
    assert counters["model.moe_choices_held"] == held
    assert counters["model.moe_host_reads"] == 1
    if skew == "held":
        assert held == 64 * 3
    else:
        assert int((picks == 0).sum()) == 64
    lp = {"norm1": {"scale": torch.ones(RED.d_model)}, "moe": p}
    u = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + RED.norm_eps)
    want = ref._moe(x, lp, rc, torch.einsum) - x
    torch.testing.assert_close(moe.share_apply(p, cfg, u, torch.float32),
                               want, rtol=0, atol=1e-5)


def test_recompute_routes_from_the_forward(monkeypatch):
    """Under remat every expert layer reads the host once (the forward);
    the recompute takes the forward's picks from the memo; the loss equals
    the one without remat, and the gradients to 1e-6 of each leaf's
    largest."""
    cfg = share(RED, 4, 2)
    seen = []
    real = moe.route_sigmoid

    def spy(p, c, x, picks=None):
        out = real(p, c, x, picks)
        seen.append((picks is None, out[0].clone()))
        return out
    monkeypatch.setattr(moe, "route_sigmoid", spy)
    with trace.recording() as rec:
        lp, gp, _, _ = both(cfg, remat=True)
    n_e = cfg.layer_kinds.count("E")
    assert rec.collect()[1][0]["model.moe_host_reads"] == n_e
    first = [pk for fresh, pk in seen[:n_e]]
    assert [fresh for fresh, _ in seen] == [True] * n_e + [False] * n_e
    again = [pk for _, pk in seen[n_e:2 * n_e]]
    for a, b in zip(first, reversed(again)):
        assert torch.equal(a, b)
    seen.clear()
    lq, gq, _, _ = both(cfg, remat=False)
    assert lq == lp
    for k in gp:      # autograd sums a leaf's parts in another order
        tol = 1e-6 * max(float(gq[k].abs().max()), 1e-30)
        assert float((gp[k] - gq[k]).abs().max()) <= tol, k


def test_configs():
    full = configs.get_config("nemotron3-nano-30b-a3b")
    assert round(full.param_count() / 1e9, 1) == 31.6
    assert full.layer_kinds.count("M") == 23 and full.layer_kinds.count(
        "E") == 23 and full.layer_kinds.count("*") == 6
    ep16 = configs.get_config("nemotron3-nano-30b-a3b-ep16")
    assert (ep16.moe.n_held, ep16.moe.n_experts, ep16.vocab_size) == (
        8, 128, 32768)
    assert not {"nemotron3-nano-30b-a3b", "nemotron3-nano-30b-a3b-ep16"} \
        & set(configs.list_archs())
    assert "nemotron" not in " ".join(configs.ARCH_IDS)
    with pytest.raises(ValueError):
        RED.replace(n_layers=53).layer_kinds
    # the defaults keep the other families' layers
    assert configs.SSMConfig().n_heads == 0 and not configs.SSMConfig() \
        .conv_bias
    assert configs.get_config("qwen2-0.5b").rope


def test_benchmark_cut_is_the_references_spec():
    """The benchmark's file names the program's config (``arch_id`` cuts
    the depth to the pattern's first 13 letters); n = 956,058,112 in the
    program's tree (6 M of 38,744,896, 5 E of 100,125,312 + a 128 bias, 2
    * of 23,399,040, embedding and head of 88,080,384, the final norm),
    leaf for leaf the reference's spec."""
    from perfbench import program
    with open(BENCH_CONFIG) as f:
        conf = json.load(f)
    arch = program.arch_id(conf)
    cfg = configs.get_config(arch)
    assert cfg.layer_kinds == "MEMEM*EMEMEM*"
    tree = configs.param_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in weights.paths(tree)}
    spec = {path: shape for path, shape, _, _ in ref.param_spec(conf)}
    assert got == spec
    n = sum(torch.Size(s).numel() for s in spec.values())
    assert n == cfg.param_count() == 956_058_112 == (
        6 * 38_744_896 + 5 * (100_125_312 + 128) + 2 * 23_399_040
        + 2 * 88_080_384 + 2688)


def test_counts_by_hand():
    """A token's gradient FLOPs at the cell's shapes: matmul parameters
    M 38,731,776 (projections 27,697,152, out 11,010,048, conv taps
    24,576), E 24,041,472 (router 344,064, shared 19,955,712, 0.375 of an
    expert's 9,977,856), * 23,396,352, head 88,080,384: 487,471,104 in 13
    layers; attention 2·4·32·128·4097/2 and the SSD 6·2,765,824 forward."""
    with open(BENCH_CONFIG) as f:
        conf = json.load(f)
    assert counts.matmul_params(conf) == 487_471_104
    want = 6 * 487_471_104 + 3 * (2 * 4 * 32 * 128 * 4097 / 2
                                  + 6 * 2_765_824)
    assert counts.grad_flops_per_token(conf, 4096) == pytest.approx(
        want, rel=1e-12)


def test_tiny_cell_through_the_harness(tmp_path):
    """A whole run of a tiny cell of the family (7 layers MEMEM*E, 4 of 8
    experts held from expert 2) through the benchmark's harness on the CPU:
    set-up, window, traced rounds and the check, correct at 1e-5."""
    from perfbench import cells, harness
    from perfbench.tests import tiny
    arch = "perfbench-tiny-nemotron"
    mod = types.ModuleType("repro_torch.configs.perfbench_tiny_nemotron")
    mod.CONFIG = mod.REDUCED = share(RED, 4, 2).replace(name=arch)
    sys.modules[mod.__name__] = mod
    configs.register(arch, mod.__name__.rsplit(".", 1)[1])
    conf = {"arch": arch, "family": "nemotron_h", "dtype": "float32",
            "tf32": False, "reduced": [], "act": "relu2", "norm_eps": 1e-5,
            "d_ff": RED.d_ff, **ref_config(mod.CONFIG)}
    limits = dict.fromkeys(("loss", "mom", "dstat", "change"), 1e-5)
    folder = tiny.checkout(str(tmp_path), limits)
    tiny._write(folder, "configs", "tiny-nemotron", conf)
    tiny._write(folder, "workloads", "tiny-nemotron.adam",
                {"config": "tiny-nemotron", "traffic": "tiny.adam",
                 "why": "a CPU test", "limits": limits})
    bench_path = tmp_path / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "tiny-nemotron.adam",
                               "config": "tiny-nemotron",
                               "traffic": "tiny.adam", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny-nemotron.adam")
    bench_path.write_text(json.dumps(bench))
    cell = cells.load(str(tmp_path), "tiny-nemotron.adam", folder)
    assert {m["name"] for m in cell.per_layer} >= {"moe_dev_ms",
                                                    "moe_route_dev_ms"}
    result, _ = harness.run(cell, 2 ** 31 + 77, 0.0, True, "cpu",
                            time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    # the device readers find nothing on the CPU and are left out
    assert "moe_dev_ms" not in result["metrics"]


@pytest.mark.cuda
def test_k7_k7b_at_8_groups_and_q128():
    """The cell's SSD call (B 2, S 4096, H 64, P 64, N 128, Q 128, 8 groups
    of B/C reaching K7 as per-head copies) on the training route: K7b
    against the plain VJP within ``k7b_bounds``, and one full-width
    Nemotron Mamba-2 layer's parameter gradients through the route against
    autograd of the plain chunked scan, each leaf to eps·max|grad| + 1e-5
    of it, eps the K7b bound's factor at the layer's max|cum|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7 and K7b have no CPU mode)")
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import layers, ssm
    from repro_torch.utils.tree import tree_paths, tree_unflatten
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cuda import _k7b_inputs, k7b_bounds
    dev = torch.device("cuda")
    B, S, H, P, N, Q, G = 2, 4096, 64, 64, 128, 128, 8
    ins, cots = _k7b_inputs(B, S, H, P, N, Q, G, dev)
    heads = tuple(ins[:3]) + (ssm.broadcast_heads(ins[3], H),
                              ssm.broadcast_heads(ins[4], H))
    want = kref.ssd_intra_chunk_vjp_ref(*heads, Q, *cots)
    got = ssd.ssd_intra_chunk_bwd(*heads, Q, *cots)
    bounds, _ = k7b_bounds(heads, Q, cots)
    for name, g, w, bd in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                              bounds):
        assert bool(((g - w).abs() <= bd).all()), name

    cfg = configs.get_config("nemotron3-nano-30b-a3b-ep16")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = ssm.init_mamba2(gen, cfg)
    for k in ("conv_x_b", "conv_B_b", "conv_C_b"):
        p[k] = 0.1 * torch.randn(p[k].shape, generator=gen, device=dev)
    u = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    real = ssm._takes_k7
    routed = []

    def grads(route):
        before = ssd.ssd_intra_chunk_bwd.launches
        paths = [(k, v.clone().requires_grad_()) for k, v in tree_paths(p)]
        ssm._takes_k7 = (lambda *t: routed.append(real(*t)) or routed[-1]) \
            if route else (lambda *t: False)
        try:
            out = ssm.mamba2_forward(tree_unflatten(p, [v for _, v in
                                                        paths]),
                                     cfg, u, torch.float32)
            g = torch.autograd.grad((out * w).sum(), [v for _, v in paths])
        finally:
            ssm._takes_k7 = real
        torch.cuda.synchronize()
        return ({k: gi for (k, _), gi in zip(paths, g)},
                ssd.ssd_intra_chunk_bwd.launches - before)

    got, n_bwd = grads(True)
    assert routed == [True] and n_bwd == 1
    want, n_plain = grads(False)
    assert n_plain == 0
    s = cfg.ssm
    dt = ssm._softplus(layers.linear(p["wdt"], u, torch.float32)
                       + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    cmax = float((dt * A.abs()).reshape(B, S // Q, Q, -1).sum(2).max())
    eps = 2.0 ** -24 * (4 * cmax + 2 * (N + Q + P + 1) + P + 16)
    for k in want:
        tol = (eps + 1e-5) * float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= tol, k


@pytest.mark.cuda
def test_share_is_deterministic_on_the_card():
    """The expert share at the cell's widths (8 of 128 experts held, a
    microbatch of 2 × 4096): two forward and backward passes give the same
    bits, the weighted scatter back included (``index_put`` with
    ``accumulate``, sort-based on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = configs.get_config("nemotron3-nano-30b-a3b-ep16")
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = moe.init_share(gen, cfg)
    x = torch.randn((2, 4096, cfg.d_model), generator=gen, device="cuda")
    w = torch.randn(x.shape, generator=gen, device="cuda")

    def run():
        leaves = [x.clone().requires_grad_(True),
                  p["experts"]["wu"].clone().requires_grad_(True),
                  p["router"]["w"].clone().requires_grad_(True)]
        q = dict(p, experts=dict(p["experts"], wu=leaves[1]),
                 router={"w": leaves[2]})
        y = moe.share_apply(q, cfg, leaves[0], torch.float32)
        return [y] + list(torch.autograd.grad((y * w).sum(), leaves))

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
