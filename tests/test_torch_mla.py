"""The port's multi-head latent attention (``models/mla.py``) and the MLA
family's model (reduced deepseek-v2-236b: one dense prefix layer, one MoE
layer of 4 routed top-2 experts and a shared MLP, MLA with a 32-wide latent,
q LoRA 48, 4 heads of nope 32 + rope 16, v 32) held against the reference,
with the reference's weights carried across by ``repro_torch.bridge``:
config and ``param_count``, the init tree (full width under
``FakeTensorMode``), ``_sdpa_dense`` with a value head narrower than the
query's, ``mla_attention`` on its three routes, ``mla_decode`` absorbed and
naive for a scalar and a per-slot position, the model's loss, gradients,
logits and prefill cache, a teacher-forced 8-step decode from the
reference's cache, the decode cache as a fixed point of a step, and the
serve entry points' ids.

Tolerances, and why: ``_sdpa_dense``, ``mla_attention`` and ``mla_decode``
to 1e-5 of the largest output magnitude (fp32 einsums of two frameworks
that add in other orders: the dense tests' tolerance); the latent caches a
decode step writes to within one bf16 ulp (the two sides round fp32 values
that agree to ~1e-7 relative to bf16, and may round them apart); the MLA
model's fp32 loss, logits and gradients under ``exact_moe`` to 1e-4 of
their largest magnitude (two attention einsums more a layer than the dense
block, and the MoE combine, on top of the dense tests' 1e-5); its bf16
latent cache to 1e-4 of its largest value plus the two roundings to bf16;
decode logits from one carried cache as ``_torch_model_parity
.teacher_forced`` holds them (1e-5; 1e-3 where a step's own bf16 entries
rounded apart); ids of two implementations under the near-tie rule; ids of
one implementation along two routes, and its absorbed and naive decode
(1e-5), as stated in each test. Routing is recorded on both sides and held
by ``_torch_moe_routing.hold_routing`` (none differs at this size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_model_parity import (assert_close, bf16_bits, bf16_close,
                                 ids_held, teacher_forced)
from _torch_moe_routing import RouteRecorder
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import value_and_grad
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ModelCallConfig, build
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TM
from repro_torch.utils.tree import tree_paths
from test_torch_moe import JaxRoutes, routing_held

torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"
B, S, G = 2, 24, 8
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "head_dim", "qkv_bias",
              "rope_theta", "norm_eps", "act", "tie_embeddings", "source",
              "frontend_tokens", "frontend_kind")
MLA_FIELDS = ("kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim")
MOE_FIELDS = ("n_experts", "n_shared", "top_k", "d_ff_expert", "d_ff_shared",
              "capacity_factor", "router_aux_weight", "moe_layer_start",
              "d_ff_dense")


# --------------------------------------------------------------------------- #
# config and init
# --------------------------------------------------------------------------- #


def test_config_matches_reference():
    for reduced in (False, True):
        j, c = jget_config(ARCH, reduced), get_config(ARCH, reduced)
        for f in CFG_FIELDS:
            assert getattr(c, f) == getattr(j, f), f
        for f in MLA_FIELDS:
            assert getattr(c.mla, f) == getattr(j.mla, f), f
        for f in MOE_FIELDS:
            assert getattr(c.moe, f) == getattr(j.moe, f), f
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
    full = get_config(ARCH)
    assert full.param_count() == 235_741_312_000
    cut = full.replace(n_layers=4)          # chip_smoke.py's phase 13
    assert cut.param_count() == 13_302_903_808
    assert cut.active_param_count() == 2_402_956_288


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_tree_matches_reference_layout(reduced):
    """The port's init has the reference's tree paths and shapes: the MLA
    tree with its head-major (r, H, n) projections in the stack (stacked
    over L) and in the dense prefix block. Full width is read from the
    port's init under ``FakeTensorMode`` (878 GiB in fp32)."""
    jcfg, cfg = jget_config(ARCH, reduced), get_config(ARCH, reduced)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    if reduced:
        tp = build(cfg).init(torch.Generator().manual_seed(0))
    else:
        with FakeTensorMode():
            tp = build(cfg).init(torch.Generator())
        assert dict(want)["blocks/stack/attn/wq_b/w"] == (59, 1536, 128, 192)
        assert dict(want)["blocks/prefix/0/attn/wo/w"] == (128, 128, 5120)
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want


def test_init_draws_at_the_reference_scales():
    """The port draws its own numbers, at the reference's scales: each
    projection's spread is its fan-in^-½ ((H·v)^-½ for ``wo``), the norms
    are ones."""
    cfg = get_config(ARCH, reduced=True)
    p = TMLA.init_mla(torch.Generator().manual_seed(0), cfg)
    m, H = cfg.mla, cfg.n_heads
    want = {"wq_a": cfg.d_model, "wq_b": m.q_lora_rank,
            "wkv_a": cfg.d_model, "wk_b": m.kv_lora_rank,
            "wv_b": m.kv_lora_rank, "wo": H * m.v_head_dim}
    for name, fan_in in want.items():
        std = float(p[name]["w"].std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.1, (name, std)
    assert torch.equal(p["q_norm"]["scale"], torch.ones(m.q_lora_rank))
    assert torch.equal(p["kv_norm"]["scale"], torch.ones(m.kv_lora_rank))


# --------------------------------------------------------------------------- #
# _sdpa_dense with Dv != D; mla_attention's three routes
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("pos_kind", ["shared", "per_slot"])
def test_sdpa_dense_with_a_narrower_value_head(pos_kind):
    """q, k (B, S, H, 48), v (B, S, H, 32) -> (B, S, H, 32), at 1e-5: the
    output reshapes to V's head dim, the scale is D^-½ of q's."""
    r = np.random.default_rng(0)
    q, k = (r.standard_normal((2, 12, 4, 48)).astype(np.float32)
            for _ in range(2))
    v = r.standard_normal((2, 12, 4, 32)).astype(np.float32)
    if pos_kind == "shared":
        qp = kp = np.arange(12, dtype=np.int32)
        valid = None
    else:
        qp = np.array([[9], [11]], np.int32)
        q = q[:, :1]
        kp = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
        valid = kp <= qp
    want = JL._sdpa_dense(*(jnp.asarray(a) for a in (q, k, v, qp, kp)), 0,
                          0.0, k_valid=None if valid is None
                          else jnp.asarray(valid))
    got = TL._sdpa_dense(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)),
                         0, 0.0, k_valid=None if valid is None
                         else torch.from_numpy(valid))
    assert got.shape == want.shape == q.shape[:3] + (32,)
    assert_close(got.numpy(), want, 1e-5, "sdpa")


@pytest.fixture(scope="module")
def mla_layer():
    """The reference's reduced init: the stack's MLA (layer 0), the prefix
    block's, and x (2, 24, d)."""
    jcfg = jget_config(ARCH, reduced=True)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    stack = jax.tree.map(lambda a: a[0], jp["blocks"]["stack"]["attn"])
    prefix = jp["blocks"]["prefix"][0]["attn"]
    x = np.random.default_rng(3).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, get_config(ARCH, reduced=True), stack, prefix, x


@pytest.mark.parametrize("which", ["stack", "prefix"])
@pytest.mark.parametrize("route", ["dense", "chunked", "kernel"])
def test_mla_attention_matches_reference(mla_layer, route, which,
                                         monkeypatch):
    """``mla_attention`` on each route against the reference's: y and the
    latent cache (c_kv, k_pe) to 1e-5. ``chunked`` (chunk 8 < S) is the
    reference's own chunked route, V zero-padded to QK's width; ``kernel``
    (K4's plain version on the CPU) is held against the reference's dense
    route, and K4 gets q and k at D = nope + rope and V padded to that
    width with zeros."""
    jcfg, cfg, stack, prefix, x = mla_layer
    p = stack if which == "stack" else prefix
    pos = np.arange(S, dtype=np.int32)
    chunk = 8 if route == "chunked" else 0
    jy, (jc, jk) = JMLA.mla_attention(jax.tree.map(jnp.asarray, p), jcfg,
                                      jnp.asarray(x), jnp.asarray(pos),
                                      jnp.float32, chunk=chunk)
    seen, real = [], ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: seen.append((q, k, v))
                        or real(q, k, v, **kw))
    with torch.no_grad():
        ty, (tc, tk) = TMLA.mla_attention(
            params_from_jax(p, "cpu"), cfg, torch.from_numpy(x),
            torch.from_numpy(pos), torch.float32, chunk=chunk,
            use_flash_kernel=route == "kernel")
    assert_close(ty.numpy(), jy, 1e-5, "y")
    assert_close(tc.numpy(), jc, 1e-5, "c_kv")
    assert_close(tk.numpy(), jk, 1e-5, "k_pe")
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert len(seen) == (route == "kernel")
    for q, k, v in seen:
        assert q.shape == k.shape == v.shape == (B, S, cfg.n_heads, qk)
        assert not bool(v[..., m.v_head_dim:].any())


def test_mla_attention_in_bf16_matches_reference(mla_layer):
    """In bf16 the frameworks round the projections at different places:
    y to 1e-2 of its largest magnitude."""
    jcfg, cfg, stack, _, x = mla_layer
    pos = np.arange(S, dtype=np.int32)
    jy, _ = JMLA.mla_attention(jax.tree.map(jnp.asarray, stack), jcfg,
                               jnp.asarray(x), jnp.asarray(pos),
                               jnp.bfloat16)
    with torch.no_grad():
        ty, _ = TMLA.mla_attention(params_from_jax(stack, "cpu"), cfg,
                                   torch.from_numpy(x),
                                   torch.from_numpy(pos), torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    assert_close(ty.float().numpy(), np.asarray(jy, np.float32), 1e-2, "y")


# --------------------------------------------------------------------------- #
# mla_decode: absorbed and naive, scalar and per-slot positions
# --------------------------------------------------------------------------- #

C = 16


def _decode_inputs(cfg, seed=5):
    """x (B, 1, d), and bf16 latent caches (B, C, ·) as numpy bf16 (the
    reference's) and their port copies."""
    r = np.random.default_rng(seed)
    m = cfg.mla
    x = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = jnp.asarray(r.standard_normal((B, C, m.kv_lora_rank)),
                      jnp.bfloat16)
    kpe = jnp.asarray(r.standard_normal((B, C, m.qk_rope_head_dim)),
                      jnp.bfloat16)
    return x, ckv, kpe


def _ulp_close(t, want, what):
    """bf16 tensors equal within one ulp (their 16-bit patterns one apart
    at most: same-sign neighbours)."""
    a = bf16_bits(t).astype(np.int32)
    b = bf16_bits(np.asarray(want)).astype(np.int32)
    assert a.shape == b.shape, what
    assert int(np.abs(a - b).max()) <= 1, what


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_mla_decode_matches_reference(mla_layer, absorbed, pos_kind):
    """One token against the latent cache, on both of the reference's
    paths: y to 1e-5; the caches, written in place by the port, to one
    bf16 ulp (the rows written) and bit for bit elsewhere. ``per_slot``
    gives each row its own position (continuous batching)."""
    jcfg, cfg, stack, _, _ = mla_layer
    x, ckv, kpe = _decode_inputs(cfg)
    if pos_kind == "scalar":
        jpos, tpos = jnp.int32(10), 10
    else:
        jpos = jnp.asarray([10, 13], jnp.int32)
        tpos = torch.tensor([10, 13], dtype=torch.int32)
    jy, jc, jk = JMLA.mla_decode(jax.tree.map(jnp.asarray, stack), jcfg,
                                 jnp.asarray(x), jpos, ckv, kpe,
                                 jnp.float32, absorbed=absorbed)
    tc = cache_from_jax(np.asarray(ckv), "cpu")
    tk = cache_from_jax(np.asarray(kpe), "cpu")
    with torch.no_grad():
        ty, tc2, tk2 = TMLA.mla_decode(params_from_jax(stack, "cpu"), cfg,
                                       torch.from_numpy(x), tpos, tc, tk,
                                       torch.float32, absorbed=absorbed)
    assert tc2 is tc and tk2 is tk                  # in place
    assert_close(ty.numpy(), jy, 1e-5, "y")
    _ulp_close(tc, jc, "ckv")
    _ulp_close(tk, jk, "kpe")
    rows = [10, 10] if pos_kind == "scalar" else [10, 13]
    for b, p in enumerate(rows):                  # only the token's row
        keep = np.arange(C) != p
        assert np.array_equal(bf16_bits(tc[b])[keep],
                              bf16_bits(np.asarray(ckv)[b])[keep])


@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_absorbed_equals_naive_in_the_port(mla_layer, pos_kind):
    """The port's two decode paths on the same cache: y to 1e-5, the
    caches they write bit for bit (the same projection)."""
    _, cfg, stack, prefix, _ = mla_layer
    x, ckv, kpe = _decode_inputs(cfg, seed=9)
    pos = 7 if pos_kind == "scalar" else torch.tensor([7, 15],
                                                      dtype=torch.int32)
    out = {}
    for absorbed in (True, False):
        for name, p in (("stack", stack), ("prefix", prefix)):
            tc = cache_from_jax(np.asarray(ckv), "cpu")
            tk = cache_from_jax(np.asarray(kpe), "cpu")
            with torch.no_grad():
                out[absorbed, name] = TMLA.mla_decode(
                    params_from_jax(p, "cpu"), cfg, torch.from_numpy(x),
                    pos, tc, tk, torch.float32, absorbed=absorbed)
    for name in ("stack", "prefix"):
        (ya, ca, ka), (yn, cn, kn) = out[True, name], out[False, name]
        assert_close(yn.numpy(), ya.numpy(), 1e-5, name)
        assert torch.equal(ca, cn) and torch.equal(ka, kn)


# --------------------------------------------------------------------------- #
# the model (reduced deepseek-v2) under exact_moe
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                           reduced=True)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labs = r.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labs[0, :3] = -1
    return jcfg, cfg, jp, toks, labs


def _batches(toks, labs):
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()})


def _models(jcfg, cfg, **kw):
    tkw = {k: v for k, v in kw.items() if k != "remat"}
    return (jbuild(jcfg, JCall(dtype=jnp.float32, exact_moe=True, **kw)),
            build(cfg, ModelCallConfig(dtype=torch.float32, exact_moe=True,
                                       remat=kw.get("remat", True),
                                       **tkw)))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(setup, remat, monkeypatch):
    """Loss (cross entropy + the router's aux) and every gradient, the
    MLA leaves of the stack and of the prefix included, to 1e-4; the
    forward's routing held."""
    jcfg, cfg, jp, toks, labs = setup
    jm, tm = _models(jcfg, cfg, remat=remat)
    jb, tb = _batches(toks, labs)
    jpa = jax.tree.map(jnp.asarray, jp)
    jl, jg = jax.value_and_grad(jm.loss)(jpa, jb)
    jr = JaxRoutes(monkeypatch)
    jm.logits(jpa, jb)
    with RouteRecorder(TM) as rec:
        tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    assert routing_held(rec.calls[:1], jr.calls[:1], cfg.moe.top_k) == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    jgd = dict(jtree_paths(jax.device_get(jg)))
    tgd = dict(tree_paths(tg))
    assert tgd.keys() == jgd.keys()
    assert "blocks/prefix/0/attn/wk_b/w" in tgd
    for k, want in jgd.items():
        assert_close(tgd[k].numpy(), want, 1e-4, k)


def test_logits_and_prefill_cache_match_reference(setup, monkeypatch):
    """``logits`` and ``prefill_cache`` to 1e-4, routing held; the decode
    cache is the latent one, ``ckv`` / ``kpe`` for the stack and
    ``p_ckv`` / ``p_kpe`` for the prefix, bf16, at the bf16 bound; the raw
    cache is each layer's (c_kv, k_pe)."""
    jcfg, cfg, jp, toks, labs = setup
    jm, tm = _models(jcfg, cfg)
    jb, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    jpa = jax.tree.map(jnp.asarray, jp)
    jr = JaxRoutes(monkeypatch)
    want_lg = jm.logits(jpa, jb)
    jl, jc = jm.prefill_cache(jpa, jb, S + 8)
    with torch.inference_mode(), RouteRecorder(TM) as rec:
        lg = tm.logits(tp, tb)
        _, raw = tm.prefill(tp, tb)
        l1, cache = tm.prefill_cache(tp, tb, S + 8)
    assert routing_held(rec.calls[:1], jr.calls[:1], cfg.moe.top_k) == 0
    assert routing_held(rec.calls[2:], jr.calls[1:], cfg.moe.top_k) == 0
    assert_close(lg.numpy(), want_lg, 1e-4, "logits")
    assert_close(l1.numpy(), jl, 1e-4, "last logits")
    m = cfg.mla
    assert raw["stack"][0].shape == (1, B, S, m.kv_lora_rank)
    assert raw["stack"][1].shape == (1, B, S, m.qk_rope_head_dim)
    assert raw["prefix0"][0].shape == (B, S, m.kv_lora_rank)
    assert sorted(cache) == sorted(jc) == ["ckv", "kpe", "p_ckv", "p_kpe"]
    for key in cache:
        assert cache[key].dtype == torch.bfloat16
        assert cache[key].shape[2] == S + 8
        bf16_close(cache[key], jc[key], 1e-4, key)


def test_prefill_cache_refuses_a_prompt_past_the_cache(setup):
    """MLA's cache is not a ring: a prompt longer than the cache raises on
    both sides."""
    jcfg, cfg, jp, toks, labs = setup
    jm, tm = _models(jcfg, cfg)
    jb, tb = _batches(toks, labs)
    with pytest.raises(AssertionError, match="not a ring"):
        jm.prefill_cache(jax.tree.map(jnp.asarray, jp), jb, S - 4)
    with pytest.raises(AssertionError, match="not a ring"):
        tm.prefill_cache(params_from_jax(jp, "cpu"), tb, S - 4)


def test_kernel_and_chunked_routes_equal_the_dense_route(setup,
                                                         monkeypatch):
    """``use_flash_kernel`` (K4's plain version on the CPU: one call a
    layer, the prefix's included) and the chunked route (chunk 8) give
    the dense route's logits and cache (1e-5; the cache at the bf16
    bound) with the same routing; ``loss`` differentiated through K4
    raises (forward-only)."""
    _, cfg, jp, toks, labs = setup
    tp = params_from_jax(jp, "cpu")
    _, tb = _batches(toks, labs)
    dense = build(cfg, ModelCallConfig(dtype=torch.float32, exact_moe=True))
    others = {
        "kernel": build(cfg, ModelCallConfig(dtype=torch.float32,
                                             exact_moe=True,
                                             use_flash_kernel=True)),
        "chunked": build(cfg, ModelCallConfig(dtype=torch.float32,
                                              exact_moe=True, attn_chunk=8,
                                              dense_attn_max=8))}
    calls, real = [], ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.inference_mode():
        with RouteRecorder(TM) as rd:
            ld, cd = dense.prefill_cache(tp, tb, S + 8)
        for name, model in others.items():
            with RouteRecorder(TM) as ro:
                lo, co = model.prefill_cache(tp, tb, S + 8)
            assert routing_held(ro.calls, rd.calls, cfg.moe.top_k) == 0
            assert_close(lo.numpy(), ld.numpy(), 1e-5, name)
            for key in cd:
                bf16_close(co[key], cd[key].float().numpy(), 1e-5, key)
    assert len(calls) == cfg.n_layers
    with pytest.raises(ValueError, match="forward-only"):
        value_and_grad(others["kernel"].loss)(tp, tb)


def _prompt(cfg, b=B, s=S, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_teacher_forced_decode_from_reference_cache(setup, pos_kind,
                                                    absorbed):
    """8 steps from the reference's prefill cache under ``exact_moe``
    (``_torch_model_parity.teacher_forced``: each step from the
    reference's latent cache, the updated ``ckv`` / ``kpe`` / ``p_ckv`` /
    ``p_kpe``, logits and ``decode_sample`` ids held), on the absorbed
    and the naive path of both sides (``mla_absorbed``)."""
    jcfg, cfg, jp, _, _ = setup
    jm, tm = _models(jcfg, cfg, mla_absorbed=absorbed)
    jb, _ = _prompt(cfg)
    assert teacher_forced(jm, tm, jp, params_from_jax(jp, "cpu"), jb, S, G,
                          pos_kind) <= 1


def test_decode_cache_is_dtype_and_shape_fixed_point(setup):
    """One decode step (per-slot positions) returns the cache of
    ``init_cache``, leaf for leaf in shape and dtype, the reference's
    (``tests/test_serve.py``'s fixed point)."""
    jcfg, cfg, jp, _, _ = setup
    jm, tm = _models(jcfg, cfg)
    jcache = jm.init_cache(2, 12)
    cache = tm.init_cache(2, 12, "cpu")
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in
            jtree_paths(jcache)}
    shapes = lambda c: {p: (tuple(x.shape), str(x.dtype).replace(
        "torch.", "")) for p, x in tree_paths(c)}
    assert shapes(cache) == want
    with torch.inference_mode():
        _, c2 = tm.decode(params_from_jax(jp, "cpu"), cache,
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    assert shapes(c2) == want


# --------------------------------------------------------------------------- #
# the serve entry points
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    return jcfg, get_config(ARCH, reduced=True), jp, params_from_jax(
        jax.device_get(jp), "cpu")


SERVE_S = 48


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_replays_the_reference(served, kernel):
    """``serve`` (capacity drops in the prefill, as the reference's) gives
    the reference's greedy ids under the near-tie rule (held on the port's
    plain logits); ``kernel`` runs K4 and K6 (plain versions on the CPU;
    MLA's decode has no K5)."""
    jcfg, cfg, jp, tp = served
    jb, tb = _prompt(cfg, s=SERVE_S, seed=7)
    want = jserve.serve(ARCH, reduced=True, batch=B, prompt_len=SERVE_S,
                        gen_len=8, seed=0, prompt=jb, verbose=False)
    got = serve.serve(ARCH, batch=B, prompt_len=SERVE_S, gen_len=8, seed=0,
                      prompt=tb, params=tp, use_flash_kernel=kernel,
                      use_decode_kernel=kernel, verbose=False, device="cpu")
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    assert ids_held(tm, tp, tb, got.tokens, np.asarray(want.tokens),
                    SERVE_S) <= 1


def test_serve_under_exact_moe_equals_the_prompt_replay(served):
    """Under ``exact_moe`` the prefill's latent cache is the one the prompt
    builds token by token through ``mla_decode`` (scalar positions):
    ``serve`` and ``serve_replay`` give the same ids, and the reference's
    ``serve_replay`` ids under the near-tie rule."""
    jcfg, cfg, jp, tp = served
    jb, tb = _prompt(cfg, s=SERVE_S, seed=7)
    kw = dict(batch=B, prompt_len=SERVE_S, gen_len=8, seed=0,
              exact_moe=True, verbose=False)
    want = jserve.serve_replay(ARCH, reduced=True, prompt=jb, **kw)
    got = serve.serve_replay(ARCH, prompt=tb, params=tp, device="cpu", **kw)
    other = serve.serve(ARCH, prompt=tb, params=tp, device="cpu", **kw)
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
    """``serve_continuous`` (MLA's per-slot decode positions) against the
    reference's on one trace and the same prompts: the schedule exactly,
    every request's ids under the near-tie rule; with ``kernel`` through
    K4 and K6."""
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


def test_continuous_tokens_equal_solo_serving(served):
    """Every request through the slot ring (per-slot positions into the
    latent cache, each admission's cache inserted into its slot) gets
    exactly the greedy tokens it gets served alone."""
    _, cfg, _, tp = served
    rc = serve.serve_continuous(ARCH, params=tp, device="cpu", **TRACE)
    _, gens = serve.poisson_trace(TRACE["n_requests"], TRACE["arrival_rate"],
                                  TRACE["seed"], TRACE["gen_len"])
    for r in range(TRACE["n_requests"]):
        solo = serve.serve(ARCH, batch=1, prompt_len=TRACE["prompt_len"],
                           gen_len=int(gens[r]),
                           cache_len=TRACE["prompt_len"] + TRACE["gen_len"],
                           prompt=serve.request_prompt(
                               cfg, TRACE["seed"], r, TRACE["prompt_len"],
                               "cpu"),
                           params=tp, verbose=False, device="cpu")
        assert np.array_equal(solo.tokens[0], rc.tokens[r]), r


def test_serve_cli_runs_deepseek_v2_with_the_kernel_flags():
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--mode",
                      "continuous", "--flash-kernel", "--decode-kernel",
                      "--requests", "4", "--batch", "2", "--prompt-len",
                      "8", "--gen-len", "4"])
    assert all(rq["finish"] is not None for rq in res.requests.values())
    cfg = get_config(ARCH, reduced=True)
    assert all(int(t.max()) < cfg.vocab_size for t in res.tokens.values())
