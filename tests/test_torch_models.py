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
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("mamba2-1.3b")


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


def test_unported_attention_paths_raise():
    cfg = get_config(ARCH, reduced=True)
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.arange(4)
    with pytest.raises(NotImplementedError, match="K4"):
        L.attention({}, cfg, x, pos, L.AttnCall(use_flash_kernel=True),
                    torch.float32)
    with pytest.raises(NotImplementedError, match="chunked"):
        L.attention({}, cfg, x, pos, L.AttnCall(chunk=2), torch.float32)
