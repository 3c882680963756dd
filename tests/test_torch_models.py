"""The port's dense model (reduced qwen2-0.5b) held against the reference,
with the reference's weights carried across by ``repro_torch.bridge``.

Tolerances: in fp32, loss to 1e-5 relative and each gradient leaf to 1e-5 of
that leaf's largest magnitude — the two backends' matmuls and reductions add
in different orders. In bf16 (the model's default compute dtype) the two
frameworks round at different places: loss to 1e-2 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.models import layers as JL
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import value_and_grad
from repro_torch.models import ModelCallConfig, build
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                            reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    labs[0, :3] = -1                       # masked positions
    return jcfg, cfg, jax.device_get(jp), toks, labs


def _batches(toks, labs):
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labs).long()}
    return jb, tb


def test_config_matches_reference():
    for reduced in (False, True):
        j, t = jget_config(ARCH, reduced=reduced), get_config(ARCH,
                                                             reduced=reduced)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "qkv_bias", "tie_embeddings",
                  "rope_theta", "norm_eps", "act", "qk_norm"):
            assert getattr(t, f) == getattr(j, f), f
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_init_tree_matches_reference_layout(setup):
    """The port's own init has the reference's tree paths and shapes (its
    draws differ: it uses a torch.Generator)."""
    jcfg, cfg, jp, _, _ = setup
    tp = build(cfg).init(torch.Generator().manual_seed(0))
    want = [(p, np.shape(x)) for p, x in jtree_paths(jp)]
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want
    assert all(x.dtype == torch.float32 for _, x in tree_paths(tp))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference_fp32(setup, remat):
    jcfg, cfg, jp, toks, labs = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, remat=remat))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat))
    jb, tb = _batches(toks, labs)
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jgd = dict(jtree_paths(jax.device_get(jg)))
    tgd = dict(tree_paths(tg))
    assert tgd.keys() == jgd.keys()
    for k, want in jgd.items():
        want = np.asarray(want)
        np.testing.assert_allclose(tgd[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_logits_match_reference_fp32(setup):
    jcfg, cfg, jp, toks, labs = setup
    jb, tb = _batches(toks, labs)
    want = np.asarray(jbuild(jcfg, JCall(dtype=jnp.float32)).logits(
        jax.tree.map(jnp.asarray, jp), jb))
    got = build(cfg, ModelCallConfig(dtype=torch.float32)).logits(
        params_from_jax(jp, "cpu"), tb)
    assert got.shape == want.shape == (2, 16, L.padded_vocab(cfg.vocab_size))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_loss_matches_reference_bf16(setup):
    jcfg, cfg, jp, toks, labs = setup
    jb, tb = _batches(toks, labs)
    jl = jbuild(jcfg, JCall()).loss(jax.tree.map(jnp.asarray, jp), jb)
    tl = build(cfg).loss(params_from_jax(jp, "cpu"), tb)
    assert build(cfg).call.dtype == torch.bfloat16
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)


# --------------------------------------------------------------------------- #
# layer-level pieces
# --------------------------------------------------------------------------- #


def test_rmsnorm_rope_and_cross_entropy_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    scale = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm({"scale": torch.from_numpy(scale)},
                  torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(5, dtype=np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 8, 10_000.0)
    tc, ts = L.rope_cos_sin(torch.from_numpy(pos), 8, 10_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)
    logits = rng.normal(size=(2, 5, 12)).astype(np.float32)
    labels = rng.integers(-1, 10, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), 10)),
        float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 10)),
        rtol=1e-6)


@pytest.mark.parametrize("window", [0, 3])
def test_dense_attention_matches_reference(window):
    """GQA 4 query heads on 2 KV heads, causal, with and without a sliding
    window."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 6, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 6, 2, 8)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    want = JL._sdpa_dense(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                          window, 0.0)
    got = L._sdpa_dense(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)),
                        window, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------------------- #
# attention routes: K4, KV-chunked (models/flash.py), dense
# --------------------------------------------------------------------------- #


def _layer0(tree):
    """Layer 0's attention params of a stacked tree."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


@pytest.fixture
def routes(monkeypatch):
    """Counts of the port's calls into K4's wrapper and models/flash.py."""
    from repro_torch.kernels import ops as kops
    seen = {"k4": 0, "chunked": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(kops, "flash_attention",
                        spy("k4", kops.flash_attention))
    monkeypatch.setattr(L, "flash_attention_bshd",
                        spy("chunked", L.flash_attention_bshd))
    return seen


# (use_flash_kernel, chunk, window, S, the reference's route): its order —
# K4 whenever its flag is set and no window masks (chunk or not), then the
# chunked route for S > chunk, then dense. The port's route is K4 whenever
# its flag is set, with the window where one masks (the TPU kernel takes
# one), else the reference's.
ROUTES = [(True, 0, 0, 64, "k4"), (True, 16, 0, 64, "k4"),
          (False, 16, 0, 64, "chunked"), (False, 16, 8, 64, "chunked"),
          (True, 16, 8, 64, "chunked"), (True, 0, 8, 64, "dense"),
          (False, 64, 0, 64, "dense")]


@pytest.mark.parametrize("flash,chunk,window,S,route", ROUTES,
                         ids=[f"{r[4]}-flash{int(r[0])}-chunk{r[1]}-win{r[2]}"
                              for r in ROUTES])
def test_attention_routes_match_reference(setup, routes, flash, chunk,
                                          window, S, route):
    """``layers.attention`` on each route against the reference's
    ``layers.attention`` with the same ``AttnCall`` (its K4 route runs the
    Pallas kernel in interpret mode; with a window and the flag, the port
    runs K4's plain version where the reference runs its chunked or dense
    route), fp32: outputs and the cache K/V to 2e-5 of their largest
    magnitude."""
    jcfg, cfg, jp, _, _ = setup
    rng = np.random.default_rng(S + chunk + window)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jpa = _layer0(jp["blocks"]["stack"]["attn"])
    tpa = _layer0(params_from_jax(jp, "cpu")["blocks"]["stack"]["attn"])
    kw = dict(window=window, chunk=chunk, use_flash_kernel=flash)
    jout, jkv = JL.attention(jax.tree.map(jnp.asarray, jpa), jcfg,
                             jnp.asarray(x), jnp.asarray(pos),
                             JL.AttnCall(**kw), jnp.float32)
    with torch.no_grad():
        tout, tkv = L.attention(tpa, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), L.AttnCall(**kw),
                                torch.float32)
    port = "k4" if flash else route
    assert routes == {"k4": int(port == "k4"),
                      "chunked": int(port == "chunked")}
    for got, want in zip((tout, *tkv), (jout, *jkv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())


def _long_batches(cfg, S=32):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    return _batches(toks, labs)


LONG = {"chunked": dict(dense_attn_max=16, attn_chunk=16),
        "flash_kernel": dict(use_flash_kernel=True)}


@pytest.mark.parametrize("name", list(LONG))
def test_long_prompt_prefill_cache_matches_reference(setup, name):
    """``prefill_cache`` at S = 32 on the chunked route (S > dense_attn_max
    = 16) and on K4, against the reference built with the same
    ``ModelCallConfig``: logits to 1e-5 of the largest, the bf16 cache
    within one bf16 ulp (rtol 2^-7)."""
    jcfg, cfg, jp, _, _ = setup
    jb, tb = _long_batches(cfg)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, **LONG[name]))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, **LONG[name]))
    jl, jc = jm.prefill_cache(jax.tree.map(jnp.asarray, jp), jb, 40)
    with torch.inference_mode():
        tl, tc = tm.prefill_cache(params_from_jax(jp, "cpu"), tb, 40)
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   rtol=2.0 ** -7, atol=0)


def test_long_prompt_loss_and_grads_match_reference_chunked(setup):
    """``loss`` and its gradients through the chunked route's recompute
    backward (S = 32 > dense_attn_max = 16), fp32, at the tolerances of
    ``test_loss_and_grads_match_reference_fp32``."""
    jcfg, cfg, jp, _, _ = setup
    jb, tb = _long_batches(cfg)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, **LONG["chunked"]))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, **LONG["chunked"]))
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tgd = dict(tree_paths(tg))
    for k, want in jtree_paths(jax.device_get(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(tgd[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_flash_kernel_loss_matches_reference_and_refuses_grads(setup):
    """With ``use_flash_kernel`` the loss runs on K4 and equals the
    reference's to 1e-5; K4 has no backward (nor has the TPU kernel), so
    differentiating it raises rather than returning no gradient."""
    jcfg, cfg, jp, _, _ = setup
    jb, tb = _long_batches(cfg)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, **LONG["flash_kernel"]))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32,
                                    **LONG["flash_kernel"]))
    tp = params_from_jax(jp, "cpu")
    with torch.no_grad():
        tl = tm.loss(tp, tb)
    np.testing.assert_allclose(
        float(tl), float(jm.loss(jax.tree.map(jnp.asarray, jp), jb)),
        rtol=1e-5)
    with pytest.raises(ValueError, match="forward-only"):
        value_and_grad(tm.loss)(tp, tb)
