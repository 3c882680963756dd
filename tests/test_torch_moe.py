"""The port's MoE family (reduced qwen2-moe-a2.7b: 4 routed experts, top 2,
one shared MLP, capacity factor 1.5) and deepseek-67b's config held against
the reference, with the reference's weights carried across by
``repro_torch.bridge``: config, ``param_count`` and ``active_param_count``,
the init tree (full width under ``FakeTensorMode``), ``moe_apply``
(grouped and flat, with and without capacity drops), loss with the router's
aux and every gradient (remat on and off), logits and the prefill cache, a
teacher-forced decode from the reference's cache, the kernel routes
(K4, K5, K6: their plain versions on the CPU), the serve entry points' ids,
continuous batching and one savic round through ``train.main``. A variant
with a dense prefix layer (``moe_layer_start`` 1, ``d_ff_dense`` 96, set on
both sides) holds the prefix blocks, their gradients and the ``pk`` /
``pv`` decode cache.

Routing is discontinuous, so every model-level hold between the two
packages records both sides' routing of every MoE layer (the port's by
``tests/_torch_moe_routing.RouteRecorder``, the reference's by a
``jax.debug.callback`` around its ``moe_apply``) and holds it with
``hold_routing``: a token whose experts differ must be a near tie (its
top-K margin within 4x the largest router-probability difference of the
tokens that agreed). At this size none differs; the tests print the count.

Tolerances, and why: routing integers (expert ids, ranks, keep, slots,
counts) exactly; the dispatch buffer exactly (copies of the tokens);
``moe_apply``'s output and aux, and the fp32 loss, logits and gradients, to
1e-5 of their largest magnitude (the frameworks' matmuls and reductions add
in other orders: the dense tests' tolerance); bf16 to 1e-2 (loss and
``moe_apply``'s output) and 5e-2 (each gradient leaf's largest magnitude),
where the frameworks round at different places; the bf16 K/V cache to 1e-5
of its largest value plus the two roundings to bf16; decode logits as
``_torch_model_parity.teacher_forced`` holds them (1e-5; 1e-3 where a
step's own bf16 K/V rounded apart); ids of two implementations under the
near-tie rule; ids and routing of one implementation along two routes
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_model_parity import (assert_close, bf16_close, ids_held,
                                 teacher_forced)
from _torch_moe_routing import RouteRecorder, hold_routing, top_k_margin
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.models import layers as JL
from repro.models import moe as JM
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import value_and_grad
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ModelCallConfig, build
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.layers import cross_entropy
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
PREFIX = dict(moe_layer_start=1, d_ff_dense=96)
B, S, G = 2, 16, 12
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "head_dim", "qk_norm",
              "qkv_bias", "rope_theta", "sliding_window", "norm_eps", "act",
              "tie_embeddings", "source", "is_attention_free")
MOE_FIELDS = ("n_experts", "n_shared", "top_k", "d_ff_expert", "d_ff_shared",
              "capacity_factor", "router_aux_weight", "moe_layer_start",
              "d_ff_dense")


def _with_prefix(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **PREFIX))


class JaxRoutes:
    """Records the reference's routing of every ``moe_apply`` call (its
    probabilities, top-K ids, keep and slot, through its own
    ``_dispatch_one``) with a ``jax.debug.callback``, in call order."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = JM.moe_apply

        def wrapped(p, cfg, x, act, dtype, capacity=None, no_drop=False,
                    grouped=True, shard=None):
            m = cfg.moe
            Bx, Sx, d = x.shape
            xg = x if grouped else x.reshape(1, Bx * Sx, d)
            N = xg.shape[1]
            C = N * m.top_k if no_drop else (capacity
                                             or JM._capacity(N, m))
            _, slot, keep, _, _, _ = jax.vmap(
                lambda xt: JM._dispatch_one(p, cfg, xt, dtype, C))(xg)
            probs = jax.nn.softmax(JL.linear(p["router"], xg, jnp.float32),
                                   axis=-1)
            _, eidx = jax.lax.top_k(probs, m.top_k)
            jax.debug.callback(self._record, probs, eidx, keep, slot,
                               ordered=True)
            return real(p, cfg, x, act, dtype, capacity=capacity,
                        no_drop=no_drop, grouped=grouped, shard=shard)

        monkeypatch.setattr(JM, "moe_apply", wrapped)

    def _record(self, probs, eidx, keep, slot):
        self.calls.append({
            "probs": torch.from_numpy(np.array(probs, np.float32)),
            "eidx": torch.from_numpy(np.array(eidx, np.int64)),
            "keep": torch.from_numpy(np.array(keep, bool)),
            "slot": torch.from_numpy(np.array(slot, np.int64))})


def routing_held(port, ref, K):
    """Hold the port's routing record against the reference's; print and
    return the count of token-layers whose experts differ."""
    r = hold_routing(port, ref, K)
    print(f"routing differences: {r['flips']} token-layers over "
          f"{len(port)} calls")
    return r["flips"]


# --------------------------------------------------------------------------- #
# configs and the init tree
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", [ARCH, "deepseek-67b"])
def test_config_matches_reference(arch):
    for reduced in (False, True):
        j, c = jget_config(arch, reduced=reduced), get_config(
            arch, reduced=reduced)
        for f in CFG_FIELDS:
            assert getattr(c, f) == getattr(j, f), f
        assert (c.moe is None) == (j.moe is None)
        for f in MOE_FIELDS if c.moe else ():
            assert getattr(c.moe, f) == getattr(j.moe, f), f
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
        if c.moe:
            pc, jc = _with_prefix(c), _with_prefix(j)
            assert pc.param_count() == jc.param_count()
            assert pc.active_param_count() == jc.active_param_count()
    if arch == ARCH:
        assert get_config(arch).param_count() == 14_315_587_584
        assert get_config(arch).active_param_count() == 2_688_976_896
    else:
        assert get_config(arch).param_count() == 67_425_001_472


@pytest.mark.parametrize("n", [1, 2, 7, 16, 24, 48, 256, 2048, 8192, 10001])
def test_capacity_matches_reference(n):
    """The same float arithmetic, truncated, up to a multiple of 8, at
    least 8 (qwen2-moe: 176 at 2048 tokens, 24 at 256, 8 at one)."""
    for reduced in (False, True):
        m, jm = get_config(ARCH, reduced).moe, jget_config(ARCH, reduced).moe
        assert TM._capacity(n, m) == JM._capacity(n, jm)
    full = get_config(ARCH).moe
    assert (TM._capacity(2048, full), TM._capacity(256, full),
            TM._capacity(1, full)) == (176, 24, 8)


@pytest.mark.parametrize("variant", ["reduced", "prefix", "full"])
def test_init_tree_matches_reference_layout(variant):
    """The port's init has the reference's tree paths and shapes: the
    stacked (L, E, d, f) expert leaves, the (L, d, E) router, the shared
    MLP, and (``prefix``) the dense prefix blocks as a list. Full width is
    read from the reference's abstract init and from the port's under
    ``FakeTensorMode`` (no storage: 57 GB at full width)."""
    reduced = variant != "full"
    jcfg, cfg = jget_config(ARCH, reduced), get_config(ARCH, reduced)
    if variant == "prefix":
        jcfg, cfg = _with_prefix(jcfg), _with_prefix(cfg)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    if reduced:
        tp = build(cfg).init(torch.Generator().manual_seed(0))
    else:
        with FakeTensorMode():
            tp = build(cfg).init(torch.Generator())
        assert dict(want)["blocks/stack/ffn/experts/wg"] == (24, 60, 2048,
                                                            1408)
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want
    assert ("prefix" in tp["blocks"]) == (variant == "prefix")


# --------------------------------------------------------------------------- #
# moe_apply and its routing
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def layer():
    """Layer 0's MoE FFN of the reference's reduced init, and x (3, 20, d)."""
    jcfg = jget_config(ARCH, reduced=True)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    p = jax.tree.map(lambda a: a[0], jp["blocks"]["stack"]["ffn"])
    x = np.random.default_rng(3).standard_normal(
        (3, 20, jcfg.d_model)).astype(np.float32)
    return jcfg, get_config(ARCH, reduced=True), p, x


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "flat"])
@pytest.mark.parametrize("cap", ["no_drop", "default", "drop"])
def test_moe_apply_matches_reference(layer, grouped, cap):
    """``moe_apply`` against the reference's on the same weights and x:
    the routing integers (top-K ids, keep, slot, per-expert counts) and
    the dispatch buffer exactly, the output and aux to 1e-5. ``drop``
    sets a capacity of 8 (fewer than a group's choices per expert), and
    the test asserts that choices were dropped."""
    jcfg, cfg, p, x = layer
    m = cfg.moe
    kw = {"no_drop": cap == "no_drop",
          "capacity": 8 if cap == "drop" else None}
    jy, ja = JM.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                          jnp.asarray(x), "silu", jnp.float32,
                          grouped=grouped, **kw)
    tp = params_from_jax(p, "cpu")
    with RouteRecorder(TM) as rec:
        ty, ta = TM.moe_apply(tp, cfg, torch.from_numpy(x), "silu",
                              torch.float32, grouped=grouped, **kw)
    assert_close(ty.numpy(), jy, 1e-5, "moe_apply output")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    xg = x if grouped else x.reshape(1, -1, x.shape[-1])
    N = xg.shape[1]
    C = N * m.top_k if kw["no_drop"] else (kw["capacity"]
                                           or JM._capacity(N, jcfg.moe))
    assert rec.calls[0]["C"] == C
    jhid, jslot, jkeep, _, _, _ = jax.vmap(
        lambda xt: JM._dispatch_one(jax.tree.map(jnp.asarray, p), jcfg, xt,
                                    jnp.float32, C))(jnp.asarray(xg))
    probs, gate, eidx, rank, keep, slot, counts, aux = TM._route(
        tp, cfg, torch.from_numpy(xg), C)
    jprobs = jax.nn.softmax(JL.linear(jax.tree.map(jnp.asarray, p["router"]),
                                      jnp.asarray(xg), jnp.float32), -1)
    _, jeidx = jax.lax.top_k(jprobs, m.top_k)
    margin = top_k_margin(torch.from_numpy(np.asarray(jprobs)), m.top_k)
    assert float(margin.min()) > 1e-4       # no near tie at this input
    assert np.array_equal(eidx.numpy(), np.asarray(jeidx))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    assert np.array_equal(rank.numpy()[keep.numpy()],
                          np.asarray(jslot)[np.asarray(jkeep)] % C)
    assert np.array_equal(counts.numpy(), np.stack(
        [np.bincount(e.reshape(-1), minlength=m.n_experts)
         for e in np.asarray(jeidx)]))
    hidden, _, _, _, _ = TM._dispatch(tp, cfg, torch.from_numpy(xg),
                                      torch.float32, C)
    assert np.array_equal(hidden.reshape(np.asarray(jhid).shape).numpy(),
                          np.asarray(jhid))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cap == "drop"), dropped


def test_moe_apply_matches_reference_bf16(layer):
    """In bf16 the frameworks round the expert products at different
    places: output to 1e-2 of its largest magnitude, aux (fp32 router) to
    1e-5."""
    jcfg, cfg, p, x = layer
    jy, ja = JM.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                          jnp.asarray(x), "silu", jnp.bfloat16)
    ty, ta = TM.moe_apply(params_from_jax(p, "cpu"), cfg,
                          torch.from_numpy(x), "silu", torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    assert_close(ty.float().numpy(), np.asarray(jy, np.float32), 1e-2,
                 "bf16 output")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_top_k_ties_go_to_the_lower_expert(layer):
    """Two router columns made equal: every token's probabilities of
    those experts tie exactly, and both packages pick the lower index
    first (``jax.lax.top_k``'s order; the port's stable sort)."""
    jcfg, cfg, p, x = layer
    p = jax.tree.map(np.array, p)
    p["router"]["w"][:, 3] = p["router"]["w"][:, 1]
    tp = params_from_jax(p, "cpu")
    probs, _, eidx, _, _, _, _, _ = TM._route(tp, cfg, torch.from_numpy(x),
                                             64)
    assert torch.equal(probs[..., 1], probs[..., 3])
    jprobs = jax.nn.softmax(JL.linear(jax.tree.map(jnp.asarray, p["router"]),
                                      jnp.asarray(x), jnp.float32), -1)
    _, jeidx = jax.lax.top_k(jprobs, cfg.moe.top_k)
    assert np.array_equal(eidx.numpy(), np.asarray(jeidx))
    both = (eidx == 1).any(-1) & (eidx == 3).any(-1)
    one = (eidx == 1).any(-1) ^ (eidx == 3).any(-1)
    assert not bool((eidx[one] == 3).any())       # 1 wins the tie
    assert bool(one.any()) or bool(both.any())


def test_grouped_routing_does_not_mix_rows(layer):
    """Grouped routing makes each batch row independent: a row routed
    beside others gives exactly what it gives alone (so padding rows, a
    ring's other slots or a static batch's repeated members never change a
    request's routing), at a capacity that drops."""
    _, cfg, p, x = layer
    tp = params_from_jax(p, "cpu")
    xt = torch.from_numpy(x)
    y, _ = TM.moe_apply(tp, cfg, xt, "silu", torch.float32, capacity=8)
    for b in range(x.shape[0]):
        yb, _ = TM.moe_apply(tp, cfg, xt[b:b + 1], "silu", torch.float32,
                             capacity=8)
        assert torch.equal(yb[0], y[b]), b


# --------------------------------------------------------------------------- #
# the model: loss with aux, gradients, logits, the prefill cache
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=["moe", "prefix"])
def setup(request):
    """Reduced qwen2-moe as registered (2 MoE layers) and with one dense
    prefix layer of FFN width 96 (one MoE layer after it); a 24-token
    batch."""
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                           reduced=True)
    if request.param == "prefix":
        jcfg, cfg = _with_prefix(jcfg), _with_prefix(cfg)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    labs = r.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    labs[0, :3] = -1
    return jcfg, cfg, jp, toks, labs


def _batches(toks, labs):
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()})


def _n_moe(cfg):
    return cfg.n_layers - cfg.moe.moe_layer_start


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference_fp32(setup, remat, monkeypatch):
    """Loss (cross entropy + the router's aux over every MoE layer) and
    every gradient to 1e-5, the routing of the forward held; with a
    prefix, its blocks' gradients too."""
    jcfg, cfg, jp, toks, labs = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, remat=remat))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat))
    jb, tb = _batches(toks, labs)
    jpa = jax.tree.map(jnp.asarray, jp)
    jl, jg = jax.value_and_grad(jm.loss)(jpa, jb)
    jr = JaxRoutes(monkeypatch)
    jm.logits(jpa, jb)                   # the forward's routing, no grad
    with RouteRecorder(TM) as rec:
        tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    n = _n_moe(cfg)
    assert routing_held(rec.calls[:n], jr.calls[:n], cfg.moe.top_k) == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jgd = dict(jtree_paths(jax.device_get(jg)))
    tgd = dict(tree_paths(tg))
    assert tgd.keys() == jgd.keys()
    assert any("router" in k for k in tgd)
    assert any(k.startswith("blocks/prefix") for k in tgd) == (
        cfg.moe.moe_layer_start > 0)
    for k, want in jgd.items():
        assert_close(tgd[k].numpy(), want, 1e-5, k)


def test_loss_and_grads_match_reference_bf16(setup):
    jcfg, cfg, jp, toks, labs = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.bfloat16))
    tm = build(cfg, ModelCallConfig(dtype=torch.bfloat16))
    jb, tb = _batches(toks, labs)
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    jgd = dict(jtree_paths(jax.device_get(jg)))
    for k, g in tree_paths(tg):
        assert_close(g.float().numpy(), np.asarray(jgd[k], np.float32),
                     5e-2, k)


def test_loss_carries_the_router_aux_through_remat(setup):
    """``loss`` is the cross entropy of ``logits`` plus the summed aux,
    the same with remat on and off (the checkpointed layer returns its aux
    beside x), and the aux is the reference's to 1e-5."""
    jcfg, cfg, jp, toks, labs = setup
    jb, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    losses = {}
    for remat in (True, False):
        tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat))
        losses[remat], _ = value_and_grad(tm.loss)(tp, tb)
    assert torch.equal(losses[True], losses[False])
    with torch.no_grad():
        ce = cross_entropy(tm.logits(tp, tb), tb["labels"], cfg.vocab_size)
    aux = float(losses[True]) - float(ce)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    jpa = jax.tree.map(jnp.asarray, jp)
    jaux = float(jm.loss(jpa, jb)) - float(JL.cross_entropy(
        jm.logits(jpa, jb), jb["labels"], jcfg.vocab_size))
    assert aux > 0.0
    np.testing.assert_allclose(aux, jaux, rtol=1e-4, atol=1e-6)


def test_logits_and_prefill_cache_match_reference(setup, monkeypatch):
    """``logits``, ``prefill`` and ``prefill_cache`` with the routing held:
    logits to 1e-5, the bf16 K/V cache (``pk`` / ``pv`` for the prefix) at
    the bf16 bound; the raw cache is the stack's (L, B, S, Hk, hd) and
    ``prefix{i}``'s (k, v)."""
    jcfg, cfg, jp, toks, labs = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    jb, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    jpa = jax.tree.map(jnp.asarray, jp)
    jr = JaxRoutes(monkeypatch)
    want_lg = jm.logits(jpa, jb)
    jl, jc = jm.prefill_cache(jpa, jb, 40)
    with torch.inference_mode(), RouteRecorder(TM) as rec:
        lg = tm.logits(tp, tb)
        l0, raw = tm.prefill(tp, tb)
        l1, cache = tm.prefill_cache(tp, tb, 40)
    n = _n_moe(cfg)
    assert routing_held(rec.calls[:n], jr.calls[:n], cfg.moe.top_k) == 0
    assert routing_held(rec.calls[2 * n:], jr.calls[n:],
                        cfg.moe.top_k) == 0
    assert_close(lg.numpy(), want_lg, 1e-5, "logits")
    assert_close(l1.numpy(), jl, 1e-5, "last logits")
    assert torch.equal(l0, l1)
    L = cfg.n_layers - cfg.moe.moe_layer_start
    assert raw["stack"][0].shape == (L, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    keys = ["k", "v"] + (["pk", "pv"] if cfg.moe.moe_layer_start else [])
    assert sorted(cache) == sorted(jc) == sorted(keys)
    assert ("prefix0" in raw) == bool(cfg.moe.moe_layer_start)
    for key in keys:
        assert cache[key].dtype == torch.bfloat16
        bf16_close(cache[key], jc[key], 1e-5, key)


def test_kernel_routes_equal_plain_routes_on_cpu(setup, monkeypatch):
    """``use_flash_kernel`` (K4's plain version on the CPU; the prefix
    block's attention too, one launch a layer) gives the plain route's
    logits, cache and routing; ``loss`` differentiated with it raises (K4
    is forward-only)."""
    _, cfg, jp, toks, labs = setup
    tp = params_from_jax(jp, "cpu")
    _, tb = _batches(toks, labs)
    plain = build(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_flash_kernel=True))
    calls, real = [], ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.inference_mode():
        with RouteRecorder(TM) as rp:
            lp, cp = plain.prefill_cache(tp, tb, 40)
        with RouteRecorder(TM) as rk:
            lk, ck = kern.prefill_cache(tp, tb, 40)
    assert len(calls) == cfg.n_layers
    assert routing_held(rk.calls, rp.calls, cfg.moe.top_k) == 0
    assert_close(lk.numpy(), lp.numpy(), 1e-5, "last logits")
    for key in cp:
        bf16_close(ck[key], cp[key].float().numpy(), 1e-5, key)
    with pytest.raises(ValueError, match="forward-only"):
        value_and_grad(kern.loss)(tp, tb)


# --------------------------------------------------------------------------- #
# decode from the reference's cache
# --------------------------------------------------------------------------- #


def _prompt(cfg, b=B, s=S, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_teacher_forced_decode_from_reference_cache(setup, pos_kind, kernel,
                                                    monkeypatch):
    """12 steps from the reference's prefill cache
    (``_torch_model_parity.teacher_forced``: each step from the
    reference's cache, the updated K/V (``pk`` / ``pv`` with a prefix),
    logits and ``decode_sample`` ids held), every step's routing held
    against the reference's (each row's one token at capacity 8: no
    drop). ``kernel`` runs K5 and K6 (plain versions on the CPU)."""
    jcfg, cfg, jp, _, _ = setup
    tp = params_from_jax(jp, "cpu")
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32,
                                    use_decode_kernel=kernel))
    jb, _ = _prompt(cfg)
    jr = JaxRoutes(monkeypatch)
    with RouteRecorder(TM) as rec:
        assert teacher_forced(jm, tm, jp, tp, jb, S, G, pos_kind) <= 1
    n = _n_moe(cfg)
    ref_steps = jr.calls[n:]                    # after the prefill's
    assert len(ref_steps) == G * n and len(rec.calls) == 2 * G * n
    for g in range(G):
        want = ref_steps[g * n:(g + 1) * n]
        for part in (0, 1):                     # decode, decode_sample
            got = rec.calls[(2 * g + part) * n:(2 * g + part + 1) * n]
            assert routing_held(got, want, cfg.moe.top_k) == 0
            assert all(not bool((~c["keep"]).any()) for c in got)


# --------------------------------------------------------------------------- #
# the serve entry points, continuous batching, one training round
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    return jcfg, get_config(ARCH, reduced=True), jp, params_from_jax(
        jax.device_get(jp), "cpu")


SERVE_S = 48            # capacity 40 a row: the seed-7 prompt drops choices


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_reuse_with_drops_replays_the_reference(served, kernel):
    """``serve`` (prefill-cache reuse) routes each prompt row at capacity
    ``_capacity(S)`` and drops the overflow, as the reference's serve: its
    greedy ids are the reference's under the near-tie rule (held on the
    port's plain logits, drops included); ``kernel`` runs K4, K5 and K6
    (plain versions on the CPU). The test asserts that the prefill
    dropped choices."""
    jcfg, cfg, jp, tp = served
    jb, tb = _prompt(cfg, s=SERVE_S, seed=7)
    want = jserve.serve(ARCH, reduced=True, batch=B, prompt_len=SERVE_S,
                        gen_len=8, seed=0, prompt=jb, verbose=False)
    with RouteRecorder(TM, min_tokens=2) as rec:
        got = serve.serve(ARCH, batch=B, prompt_len=SERVE_S, gen_len=8,
                          seed=0, prompt=tb, params=tp,
                          use_flash_kernel=kernel, use_decode_kernel=kernel,
                          verbose=False, device="cpu")
    assert sum(int((~c["keep"]).sum()) for c in rec.calls) > 0
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    assert ids_held(tm, tp, tb, got.tokens, np.asarray(want.tokens),
                    SERVE_S) <= 1


@pytest.mark.parametrize("mode", ["replay", "reuse"])
def test_serve_under_exact_moe_replays_the_reference(served, mode):
    """Under ``exact_moe`` (no capacity drops), ``serve_replay`` (the prompt
    token by token through ``decode``) and ``serve`` give the reference's
    ids under the near-tie rule, and each other's exactly: the parity the
    reference's own serve test holds for MoE."""
    jcfg, cfg, jp, tp = served
    jb, tb = _prompt(cfg, s=SERVE_S, seed=7)
    kw = dict(batch=B, prompt_len=SERVE_S, gen_len=8, seed=0,
              exact_moe=True, verbose=False)
    jfn = jserve.serve_replay if mode == "replay" else jserve.serve
    fn = serve.serve_replay if mode == "replay" else serve.serve
    want = jfn(ARCH, reduced=True, prompt=jb, **kw)
    got = fn(ARCH, prompt=tb, params=tp, device="cpu", **kw)
    other = (serve.serve if mode == "replay" else serve.serve_replay)(
        ARCH, prompt=tb, params=tp, device="cpu", **kw)
    assert np.array_equal(got.tokens, other.tokens)
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, exact_moe=True))
    assert ids_held(tm, tp, tb, got.tokens, np.asarray(want.tokens),
                    SERVE_S) <= 1


TRACE = dict(reduced=True, slots=3, n_requests=6, prompt_len=SERVE_S,
             gen_len=6, arrival_rate=0.7, seed=0, verbose=False)
SCHEDULE_METRICS = ("n_requests", "slots", "total_tokens", "makespan_steps",
                    "tok_per_step", "decode_steps", "mean_queue_delay_steps",
                    "max_queue_delay_steps")


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_continuous_matches_the_reference(served, monkeypatch, kernel):
    """``serve_continuous`` against the reference's on one trace and the
    same prompts (the reference's ``request_prompt`` is salted per
    process, so both get the port's), capacity drops in each admission's
    B=1 prefill: the schedule exactly, every request's ids under the
    near-tie rule; with ``kernel`` through K4, K5 and K6."""
    jcfg, cfg, jp, tp = served
    prompts = [serve.request_prompt(cfg, 0, r, TRACE["prompt_len"], "cpu")
               for r in range(TRACE["n_requests"])]
    monkeypatch.setattr(jserve, "request_prompt", lambda c, s, r, n: {
        k: jnp.asarray(v.numpy()) for k, v in prompts[r].items()})
    want = jserve.serve_continuous(ARCH, **TRACE)
    got = serve.serve_continuous(ARCH, device="cpu", params=tp,
                                 prompts=prompts, use_flash_kernel=kernel,
                                 use_decode_kernel=kernel, **TRACE)
    assert got.requests == want.requests
    for key in SCHEDULE_METRICS:
        assert got.metrics[key] == want.metrics[key], key
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    ties = 0
    for r in range(TRACE["n_requests"]):
        g, w = got.tokens[r], np.asarray(want.tokens[r])
        assert g.shape == w.shape, r
        ties += ids_held(tm, tp, prompts[r], g[None], w[None],
                         TRACE["prompt_len"])
    assert ties <= 1


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_continuous_tokens_equal_solo_and_static(served, kernel):
    """Every request through the slot ring gets exactly the greedy tokens it
    gets served alone and in the static batches (padded by repetition):
    grouped routing keeps each row's capacity its own."""
    _, cfg, _, tp = served
    kw = dict(TRACE, use_decode_kernel=kernel, use_flash_kernel=kernel,
              params=tp, device="cpu")
    rc = serve.serve_continuous(ARCH, **kw)
    rs = serve.serve_static(ARCH, **kw)
    _, gens = serve.poisson_trace(TRACE["n_requests"], TRACE["arrival_rate"],
                                  TRACE["seed"], TRACE["gen_len"])
    for r in range(TRACE["n_requests"]):
        assert np.array_equal(rc.tokens[r], rs.tokens[r]), r
        solo = serve.serve(ARCH, batch=1, prompt_len=TRACE["prompt_len"],
                           gen_len=int(gens[r]),
                           cache_len=TRACE["prompt_len"] + TRACE["gen_len"],
                           prompt=serve.request_prompt(
                               cfg, TRACE["seed"], r, TRACE["prompt_len"],
                               "cpu"),
                           use_decode_kernel=kernel,
                           use_flash_kernel=kernel, params=tp,
                           verbose=False, device="cpu")
        assert np.array_equal(solo.tokens[0], rc.tokens[r]), r


def test_serve_cli_runs_moe_with_the_kernel_flags():
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--mode",
                      "continuous", "--flash-kernel", "--decode-kernel",
                      "--requests", "4", "--batch", "2", "--prompt-len",
                      "8", "--gen-len", "4"])
    assert all(rq["finish"] is not None for rq in res.requests.values())
    cfg = get_config(ARCH, reduced=True)
    assert all(int(t.max()) < cfg.vocab_size for t in res.tokens.values())


def test_exact_moe_reaches_every_entry_point(monkeypatch):
    """The keyword reaches the model's call config from ``serve``,
    ``serve_replay``, ``serve_continuous`` and ``serve_static``."""
    seen = []
    real = serve.build

    def spy(cfg, call):
        seen.append(call.exact_moe)
        return real(cfg, call)

    monkeypatch.setattr(serve, "build", spy)
    kw = dict(device="cpu", verbose=False, exact_moe=True)
    serve.serve(ARCH, batch=1, prompt_len=4, gen_len=2, **kw)
    serve.serve_replay(ARCH, batch=1, prompt_len=4, gen_len=2, **kw)
    for fn in (serve.serve_continuous, serve.serve_static):
        fn(ARCH, slots=2, n_requests=2, prompt_len=4, gen_len=2, **kw)
    assert seen == [True] * 4


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
def test_savic_round_matches_the_reference(served, fused):
    """One savic round of reduced qwen2-moe through ``train.main`` (tree
    loop, and the fused loop on K1's plain version) from the reference's
    weights, against the reference's ``train.main``: loss (with the
    router's aux) and drift to 1e-5 relative (the dense engine tests'
    tolerance)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    _, _, jp, _ = served
    argv = ["--arch", ARCH, "--reduced", "--method", "savic", "--rounds",
            "1", "--h-local", "2", "--clients", "2", "--batch", "2",
            "--seq", "32"]
    want = jtrain.main(argv)
    np_params = jax.device_get(jp)
    got = train.main(argv + ["--device", "cpu"]
                     + (["--use-fused-kernel"] if fused else []),
                     init_params=lambda g: params_from_jax(np_params,
                                                           g.device))
    for k in ("loss", "drift"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5)


# --------------------------------------------------------------------------- #
# deepseek-67b: a dense config, reduced
# --------------------------------------------------------------------------- #


def test_deepseek_67b_reduced_loss_and_grads_match_reference():
    """deepseek-67b needs no model code of its own (dense, GQA 8 of 64 at
    full width, 2 of 8 reduced): its reduced loss and every gradient to
    1e-5 in fp32."""
    jcfg = jget_config("deepseek-67b", reduced=True)
    cfg = get_config("deepseek-67b", reduced=True)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jb, tb = _batches(toks, toks)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jgd = dict(jtree_paths(jax.device_get(jg)))
    for k, g in tree_paths(tg):
        assert_close(g.numpy(), jgd[k], 1e-5, k)
    assert T._n_prefix(cfg) == 0
