"""The port's hybrid family (reduced zamba2-2.7b: mamba2 layers with one
weight-tied attention + MLP block after every ``hybrid_attn_every``-th)
held against the reference, with the reference's weights carried across by
``repro_torch.bridge``: config and init tree, loss and every gradient
(the shared block's summed over its applications), logits, the prefill
cache (mamba states and ``shared_k`` / ``shared_v``), a teacher-forced
32-step decode, the ``decode_window`` ring of the shared cache, the kernel
routes (K7 for the SSD, K4 and K5 for the shared attention, K6 for the
sampling: their plain versions on the CPU) against the plain ones, and the
serve entry points' ids.

The registered reduced config has 2 layers and ``hybrid_attn_every`` 2: one
application. The model tests deepen it to 4 layers (``DEEP``), on both
sides, so that the shared block runs twice and its gradient is a sum.

Tolerances, and why. Model outputs in fp32 (loss, logits, gradients, the
mamba states) are held to (eps + 1e-5)·max|value|: eps is the SSD's
rounding bound of ``tests/test_torch_ssm.py`` (u·(4(Q-1)·max|cum| + N + Q
+ 2·nc + 8), u = 2^-24, max|cum| recorded over every SSD call of the run),
1e-5 the dense tests' fp32 tolerance for the attention, MLP and
projections, which add in other orders in the two frameworks. In bf16 (the
default compute dtype) the frameworks round at different places: loss to
1e-2 relative, gradients to 5e-2 of each leaf's largest magnitude, as the
dense and ssm tests. The bf16 shared K/V caches: the fp32 bound (the prefill's,
or 1e-5 after a decode step from one carried cache) plus the two roundings
to bf16 (2^-7 of the element). Decode logits from the
same cache: 1e-5 of the largest logit (a decode step has no cumsum), 1e-3
where the step's own bf16 K/V rounded apart on the two sides (at most
three quarters of the steps; ids then held to the port's own logits). Ids
of two implementations: the near-tie rule of
``repro_torch.kernels.ref.near_tie_check`` while a row's earlier ids agree;
ids of one implementation along two routes, and schedules: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_model_parity import (assert_close, bf16_close, ids_held,
                                 teacher_forced, to_jax_cache)
from _torch_ssd_route import k7_route
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import value_and_grad
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ModelCallConfig, build
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
U = 2.0 ** -24
DEEP = dict(n_layers=4)            # two applications of the shared block
B, S, G = 2, 16, 32


def eps_ssd(cum_max, Q, N, nc):
    return U * (4 * (Q - 1) * cum_max + N + Q + 2 * nc + 8)


def cum_max(dt, A, chunk):
    dt = np.asarray(dt, np.float64)
    b, s, h = dt.shape
    dA = np.abs(dt * np.asarray(A, np.float64)[None, None, :])
    return float(dA.reshape(b, s // chunk, chunk, h).sum(2).max())


class CumSpy:
    """Records max|cum| over every SSD call of the port's model (either
    route), for the model-level eps."""

    def __init__(self, monkeypatch):
        self.max, self.Q, self.N, self.nc = 0.0, 1, 1, 1
        monkeypatch.setattr(SSM, "ssd_chunked", self._wrap(SSM.ssd_chunked))

    def _wrap(self, fn):
        def spy(xh, dt, A, Bm, Cm, chunk, **kw):
            self.max = max(self.max, cum_max(dt.detach().float().numpy(),
                                             A.detach().numpy(), chunk))
            self.Q, self.N = chunk, Bm.shape[-1]
            self.nc = xh.shape[1] // chunk
            return fn(xh, dt, A, Bm, Cm, chunk=chunk, **kw)
        return spy

    @property
    def tol(self):
        """The relative tolerance of an fp32 model output."""
        return eps_ssd(self.max, self.Q, self.N, self.nc) + 1e-5


# --------------------------------------------------------------------------- #
# config and init
# --------------------------------------------------------------------------- #


def test_config_matches_reference():
    for reduced in (False, True):
        j, c = jget_config(ARCH, reduced=reduced), get_config(ARCH,
                                                             reduced=reduced)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "hybrid_attn_every", "sliding_window", "qk_norm",
                  "qkv_bias", "rope_theta", "norm_eps", "act",
                  "tie_embeddings", "source", "is_attention_free"):
            assert getattr(c, f) == getattr(j, f), f
        for f in ("d_state", "d_conv", "expand", "head_dim", "chunk",
                  "ngroups"):
            assert getattr(c.ssm, f) == getattr(j.ssm, f), f
        assert c.param_count() == j.param_count()
    # the reference's formula, copied as it is: the shared MLP counts 3d²
    assert get_config(ARCH).param_count() == 2_363_261_088


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_tree_matches_reference_layout(reduced):
    """The port's init has the reference's tree paths and shapes, the
    shared block at ``shared/{norm1, attn/{wq,wk,wv,wo}, norm2,
    ffn/{wg,wu,wd}}``. Full width is read from the reference's abstract
    init only (2,426,319,008 parameters) and from the port's init under
    ``FakeTensorMode`` (no storage)."""
    jcfg, cfg = jget_config(ARCH, reduced=reduced), get_config(
        ARCH, reduced=reduced)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    if reduced:
        tp = build(cfg).init(torch.Generator().manual_seed(0))
    else:
        assert sum(int(np.prod(s)) for _, s in want) == 2_426_319_008
        with FakeTensorMode():
            tp = build(cfg).init(torch.Generator())
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want
    assert all(x.dtype == torch.float32 for _, x in tree_paths(tp))
    assert sorted(tp["blocks"]["shared"]) == ["attn", "ffn", "norm1",
                                              "norm2"]
    assert "norm2" not in tp["blocks"]["stack"]


# --------------------------------------------------------------------------- #
# the model: loss, gradients, logits, prefill cache
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def deep():
    jcfg = jget_config(ARCH, reduced=True).replace(**DEEP)
    cfg = get_config(ARCH, reduced=True).replace(**DEEP)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    labs = r.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    labs[0, :3] = -1
    return jcfg, cfg, jp, toks, labs


def _batches(toks, labs):
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()})


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference_fp32(deep, monkeypatch, remat):
    """Loss and every gradient leaf against ``jax.value_and_grad``; the
    shared block's leaves carry the sum over its two applications (the
    reference's scan differentiates through both)."""
    jcfg, cfg, jp, toks, labs = deep
    spy = CumSpy(monkeypatch)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, remat=remat))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat))
    jb, tb = _batches(toks, labs)
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    assert abs(float(tl) - float(jl)) <= spy.tol * abs(float(jl))
    jgrads = dict(jtree_paths(jax.device_get(jg)))
    got = dict(tree_paths(tg))
    assert got.keys() == jgrads.keys()
    assert any(p.startswith("blocks/shared/attn") for p in got)
    for path, g in got.items():
        assert_close(g.numpy(), jgrads[path], spy.tol, path)


def test_loss_and_grads_match_reference_bf16(deep):
    jcfg, cfg, jp, toks, labs = deep
    jm = jbuild(jcfg, JCall(dtype=jnp.bfloat16))
    tm = build(cfg, ModelCallConfig(dtype=torch.bfloat16))
    jb, tb = _batches(toks, labs)
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    jgrads = dict(jtree_paths(jax.device_get(jg)))
    for path, g in tree_paths(tg):
        w = np.asarray(jgrads[path], np.float32)
        assert_close(g.float().numpy(), w, 5e-2, path)


def test_shared_block_gradient_sums_its_applications(deep, monkeypatch):
    """With the shared block untied into one copy per application, the tied
    gradient is the sum of the copies' gradients (fp32, to 1e-6 of each
    leaf's largest magnitude: the same operations, summed in another
    order)."""
    _, cfg, jp, toks, labs = deep
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=False))
    _, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    _, tied = value_and_grad(tm.loss)(tp, tb)
    real = T._attn_block

    def untied_loss(copies, batch):
        seen = []

        def attn_block(sp, *a, **kw):
            seen.append(len(seen))
            return real(copies[len(seen) - 1], *a, **kw)

        monkeypatch.setattr(T, "_attn_block", attn_block)
        loss = tm.loss(tp, batch)
        monkeypatch.setattr(T, "_attn_block", real)
        assert len(seen) == 2
        return loss

    napp = cfg.n_layers // cfg.hybrid_attn_every
    copies = [tp["blocks"]["shared"]] * napp
    _, per_app = value_and_grad(untied_loss)(copies, tb)
    want = dict(tree_paths(tied["blocks"]["shared"]))
    for path, w in want.items():
        total = sum(dict(tree_paths(g))[path] for g in per_app)
        assert_close(total.numpy(), w.numpy(), 1e-6, path)
        assert all(float(dict(tree_paths(g))[path].abs().max()) > 0
                   for g in per_app), path


def test_logits_and_prefill_cache_match_reference(deep, monkeypatch):
    """``logits``, ``prefill`` and ``prefill_cache``: the last logits and
    the mamba states at the fp32 tolerance, ``shared_k`` / ``shared_v``
    (one row per application) within one bf16 ulp. ``prefill``'s raw cache
    keeps the shared K/V of the applications only."""
    jcfg, cfg, jp, toks, labs = deep
    spy = CumSpy(monkeypatch)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    jb, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    jpa = jax.tree.map(jnp.asarray, jp)
    with torch.inference_mode():
        lg = tm.logits(tp, tb)
        l0, raw = tm.prefill(tp, tb)
        l1, cache = tm.prefill_cache(tp, tb, 80)
    assert_close(lg.numpy(), jm.logits(jpa, jb), spy.tol, "logits")
    jl, jc = jm.prefill_cache(jpa, jb, 80)
    assert_close(l1.numpy(), jl, spy.tol, "last logits")
    assert torch.equal(l0, l1)
    napp = cfg.n_layers // cfg.hybrid_attn_every
    assert set(cache) == {"mamba", "shared_k", "shared_v"}
    assert set(raw["stack"]) == {"mamba", "skv"}
    assert raw["stack"]["skv"][0].shape == (napp, 2, 64, cfg.n_kv_heads,
                                            cfg.head_dim)
    for key, w in jc["mamba"].items():
        got = cache["mamba"][key]
        assert got.dtype == torch.float32 and got.shape[:2] == (
            cfg.n_layers, 2)
        assert_close(got.numpy(), w, spy.tol, key)
    for key in ("shared_k", "shared_v"):
        assert cache[key].shape == (napp, 2, 80, cfg.n_kv_heads,
                                    cfg.head_dim)
        assert cache[key].dtype == torch.bfloat16
        bf16_close(cache[key], jc[key], spy.tol, key)


def test_kernel_routes_equal_plain_routes_on_cpu(deep, monkeypatch):
    """The card's SSD route (forced) and ``use_flash_kernel`` (K7's, K7b's
    and K4's plain versions on the CPU) give the plain routes' logits and
    cache, and the plain loss without grad; differentiated, the SSD route
    gives the plain route's loss and gradient (each leaf to the tolerance
    of its largest magnitude), and ``use_flash_kernel`` raises (K4's
    serving instance is forward-only)."""
    _, cfg, jp, toks, labs = deep
    spy = CumSpy(monkeypatch)
    tp = params_from_jax(jp, "cpu")
    _, tb = _batches(toks, labs)
    plain = build(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_flash_kernel=True))
    with torch.inference_mode():
        lp, cp = plain.prefill_cache(tp, tb, 80)
        lossp = plain.loss(tp, tb)
    gl, gg = value_and_grad(plain.loss)(tp, tb)
    k7_route(monkeypatch)
    with torch.inference_mode():
        lk, ck = kern.prefill_cache(tp, tb, 80)
        lossk = kern.loss(tp, tb)
    kl, kg = value_and_grad(plain.loss)(tp, tb)
    assert_close(lk.numpy(), lp.numpy(), spy.tol, "last logits")
    for key in cp["mamba"]:
        assert_close(ck["mamba"][key].numpy(), cp["mamba"][key].numpy(),
                     spy.tol, key)
    for key in ("shared_k", "shared_v"):
        bf16_close(ck[key], cp[key].float().numpy(), spy.tol, key)
    assert abs(float(lossk) - float(lossp)) <= spy.tol * abs(float(lossp))
    assert abs(float(kl) - float(gl)) <= spy.tol * abs(float(gl))
    want = dict(tree_paths(gg))
    for path, g in tree_paths(kg):
        assert_close(g.numpy(), want[path].numpy(), spy.tol, path)
    with pytest.raises(ValueError, match="forward-only"):
        value_and_grad(kern.loss)(tp, tb)


def test_kernel_routes_run_per_layer_and_application(deep, monkeypatch):
    """The SSD route (forced) runs one call of its composition a mamba
    layer, the K4 route one ``ops.flash_attention`` an application of the
    shared block; the plain routes run neither."""
    _, cfg, jp, toks, labs = deep
    flash_calls = []
    real_flash = ops.flash_attention

    def flash(*a, **kw):
        flash_calls.append(1)
        return real_flash(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", flash)
    _, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    for kernel in (False, True):
        flash_calls.clear()
        ssd_calls = k7_route(monkeypatch, force=kernel)
        model = build(cfg, ModelCallConfig(dtype=torch.float32,
                                           use_flash_kernel=kernel))
        with torch.inference_mode():
            model.prefill_cache(tp, tb, 80)
        assert len(ssd_calls) == cfg.n_layers * kernel
        assert len(flash_calls) == cfg.n_layers // cfg.hybrid_attn_every \
            * kernel


# --------------------------------------------------------------------------- #
# decode: the cache, teacher-forced steps, the ring
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, reduced=True).replace(**DEEP)
    cfg = get_config(ARCH, reduced=True).replace(**DEEP)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.device_get(jp), "cpu")


def _prompt(cfg, b=B, s=S, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks)})


def _models(jcfg, cfg, window=0, **kw):
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, decode_window=window))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32,
                                    decode_window=window, **kw))
    return jm, tm


@pytest.mark.parametrize("window", [0, 12], ids=["full", "ring"])
def test_init_cache_layout_matches_reference(weights, window):
    """``init_cache`` is the reference's tree: the mamba leaves stacked
    over L (fp32), ``shared_k`` / ``shared_v`` (L // every, B, C, Hk, hd)
    bf16 with C the ring's size under ``decode_window``."""
    jcfg, cfg, _, _ = weights
    jm, tm = _models(jcfg, cfg, window)
    jc = jm.init_cache(3, 40)
    tc = tm.init_cache(3, 40, "cpu")
    assert set(tc) == set(jc) == {"mamba", "shared_k", "shared_v"}
    for path, w in jtree_paths(jc):
        got = dict(tree_paths(tc))[path]
        assert tuple(got.shape) == w.shape, path
        assert str(got.dtype)[6:] == str(w.dtype), path
        assert not got.any()
    assert tc["shared_k"].shape[2] == (window or 40)


@pytest.mark.parametrize("window", [0, 12], ids=["full", "ring"])
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_teacher_forced_decode_from_reference_cache(weights, pos_kind,
                                                    kernel, window):
    """32 steps from the reference's prefill cache
    (``_torch_model_parity.teacher_forced``: each step from the
    reference's cache, the updated mamba states and shared K/V, the logits
    and the ``decode_sample`` ids held; measured, the logits differ by
    ~7e-7 of their largest, up to 1.0e-5 where the step's new K/V rounded
    to neighbouring bf16 values on the two sides). ``kernel`` runs K5 and
    K6 (their plain versions on the CPU); ``ring`` decodes through a
    12-slot ring that the 16-token prompt has already wrapped."""
    jcfg, cfg, jp, tp = weights
    jm, tm = _models(jcfg, cfg, window, use_decode_kernel=kernel)
    jb, _ = _prompt(cfg)
    assert teacher_forced(jm, tm, jp, tp, jb, S, G, pos_kind) <= 1


@pytest.mark.parametrize("window", [0, 12, 16], ids=["full", "S>C", "S=C"])
def test_prefill_cache_ring_matches_reference(weights, window, monkeypatch):
    """``prefill_cache`` under ``decode_window``: the shared K/V of each
    application ring-placed (slot = pos % C, the last C positions) as the
    reference places them, at the bf16 bound of the prefill's tolerance."""
    jcfg, cfg, jp, tp = weights
    spy = CumSpy(monkeypatch)
    jm, tm = _models(jcfg, cfg, window)
    jb, tb = _prompt(cfg)
    jl, jc = jax.jit(jm.prefill_cache, static_argnums=2)(jp, jb, S + G)
    with torch.inference_mode():
        tl, tc = tm.prefill_cache(tp, tb, S + G)
    assert_close(tl, jl, spy.tol, "last logits")
    C = window or S + G
    for key in ("shared_k", "shared_v"):
        assert tc[key].shape[2] == C
        bf16_close(tc[key], jc[key], spy.tol, key)


def test_reference_decodes_from_the_port_prefill_cache(weights):
    """The other way round: the port's prefill cache, carried into the
    reference, decodes to the port's own logits."""
    jcfg, cfg, jp, tp = weights
    jm, tm = _models(jcfg, cfg)
    _, tb = _prompt(cfg)
    with torch.inference_mode():
        tl, tcache = tm.prefill_cache(tp, tb, S + G)
        jcache = to_jax_cache(tcache)
        tok = torch.argmax(tl, -1).to(torch.int32)
        tl, tcache = tm.decode(tp, tcache, tok, S)
    jl, _ = jax.jit(jm.decode)(jp, jcache, jnp.asarray(tok.numpy()),
                               jnp.int32(S))
    assert_close(tl, jl, 1e-5, "logits")


def test_per_slot_decode_bitwise_equals_scalar(weights):
    """decode with pos = full((B,), p) is bitwise the scalar-pos decode;
    every cache leaf is updated in place."""
    _, cfg, _, tp = weights
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    _, tb = _prompt(cfg)
    with torch.inference_mode():
        _, cs = tm.prefill_cache(tp, tb, S + G)
        cv = {"mamba": {k: v.clone() for k, v in cs["mamba"].items()},
              "shared_k": cs["shared_k"].clone(),
              "shared_v": cs["shared_v"].clone()}
        sk, h = cs["shared_k"], cs["mamba"]["h"]
        tok_s = tok_v = torch.zeros((B,), dtype=torch.int32)
        for g in range(4):
            ls, cs2 = tm.decode(tp, cs, tok_s, S + g)
            lv, cv2 = tm.decode(tp, cv, tok_v,
                                torch.full((B,), S + g, dtype=torch.int32))
            assert cs2 is cs and cv2 is cv
            assert cs["shared_k"] is sk and cs["mamba"]["h"] is h
            assert torch.equal(ls, lv), g
            tok_s = tok_v = torch.argmax(ls, -1).to(torch.int32)
        for (_, a), (_, b) in zip(tree_paths(cs), tree_paths(cv)):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the serve entry points against the reference's launch/serve.py
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def served():
    """The registered reduced config (2 layers, one application) with the
    weights the reference's serve makes for seed 0."""
    jcfg = jget_config(ARCH, reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    return jcfg, cfg, jp, params_from_jax(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_replays_the_reference(served, monkeypatch, kernel):
    """``serve`` on the reference's weights and prompt gives the
    reference's greedy ids under the near-tie rule; ``kernel`` runs the
    prefill on the card's SSD route (forced) and K4's and the decode on
    K5's and K6's (their plain versions on the CPU)."""
    jcfg, cfg, jp, tp = served
    k7_route(monkeypatch, force=kernel)
    jb, tb = _prompt(cfg, seed=7)
    want = jserve.serve(ARCH, reduced=True, batch=B, prompt_len=S,
                        gen_len=12, seed=0, prompt=jb, verbose=False)
    got = serve.serve(ARCH, batch=B, prompt_len=S, gen_len=12, seed=0,
                      prompt=tb, params=tp, use_flash_kernel=kernel,
                      use_decode_kernel=kernel, verbose=False, device="cpu")
    assert got.tokens.shape == (B, 12)
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    assert ids_held(tm, tp, tb, got.tokens, np.asarray(want.tokens),
                     S) <= 1


TRACE = dict(reduced=True, slots=3, n_requests=6, prompt_len=8, gen_len=6,
             arrival_rate=0.7, seed=0, verbose=False)
SCHEDULE_METRICS = ("n_requests", "slots", "total_tokens", "makespan_steps",
                    "tok_per_step", "decode_steps", "mean_queue_delay_steps",
                    "max_queue_delay_steps")


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_continuous_matches_the_reference(served, monkeypatch, kernel):
    """``serve_continuous`` against the reference's on one trace, the
    reference's seed-0 weights and the same prompts (the reference's
    ``request_prompt`` is salted per process, so both get the port's):
    the schedule exactly, every request's ids under the near-tie rule
    (teacher-forced solo on the port's plain logits); ``kernel`` forces
    the card's SSD route and runs K4, K5 and K6's plain versions."""
    jcfg, cfg, jp, tp = served
    k7_route(monkeypatch, force=kernel)
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
def test_continuous_tokens_equal_solo_and_static(served, monkeypatch,
                                                  kernel):
    """Every request through the slot ring (its B=1 cache tree, the shared
    K/V included, inserted into a slot) gets exactly the greedy tokens it
    gets served alone and in the static batches; ``kernel`` forces the
    card's SSD route and runs K4, K5 and K6's plain versions."""
    _, cfg, _, tp = served
    k7_route(monkeypatch, force=kernel)
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


def test_serve_cli_runs_the_hybrid_with_every_kernel_flag(monkeypatch):
    k7_route(monkeypatch)
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--mode",
                      "continuous", "--flash-kernel", "--decode-kernel",
                      "--requests", "4", "--batch", "2", "--prompt-len", "8",
                      "--gen-len", "4"])
    assert all(rq["finish"] is not None for rq in res.requests.values())
    cfg = get_config(ARCH, reduced=True)
    assert all(int(t.max()) < cfg.vocab_size for t in res.tokens.values())


# --------------------------------------------------------------------------- #
# one reduced savic round through train.main, against the reference engine
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
def test_savic_round_matches_the_reference(served, fused):
    """One savic round of the reduced hybrid through ``train.main`` (tree
    loop, and the fused loop on K1's plain version), from the reference's
    weights, against the reference's ``train.main``: loss and drift to
    1e-4 relative (two local steps of fp32 gradients whose SSD rounds at
    eps ~1e-4 of this model)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    jcfg, _, jp, _ = served
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
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4)
