"""The port's qwen3-4b (dense, GQA 8 of 32 heads, qk-norm, rope theta 1e6)
and its ``qwen3-4b-swa`` variant (a sliding window of 8192) held against
the reference, on the reduced config with the reference's weights carried
across by ``repro_torch.bridge``: config, variant and init tree, loss and
every gradient, logits, the prefill cache, a teacher-forced 32-step
decode, the sliding window and the ``decode_window`` ring, the kernel
routes (K4, K5, K6: their plain versions on the CPU) against the plain
ones, the serve entry points' ids, and one savic round through ``train.main``.

qwen3 needs no model code of its own: the dense block applies the qk-norm
(``layers.attention``, ``attention_decode``) and carries ``rope_theta``.
The swa variant's reduced config is the reduced qwen3 (as in the
reference, no window), so the window tests set ``sliding_window`` on the
reduced config of both sides (``SWA_REDUCED``).

Tolerances, and why: fp32 loss, logits and gradients to 1e-5 of their
largest magnitude (the dense tests': the two frameworks' matmuls and
reductions add in other orders); bf16 to 1e-2 (loss) and 5e-2 (each
gradient leaf's largest magnitude), where the frameworks round at
different places; the bf16 K/V cache to 1e-5 of its largest value plus
the two roundings to bf16 (2^-7 of the element); decode logits from one
carried cache to 1e-5, 1e-3 where the step's own K/V rounded to
neighbouring bf16 values on the two sides (they are rounded before they
are attended to; measured up to 1.2e-4 in the 12-slot ring), at most
three quarters of the steps, ids then held to the port's own logits; ids
of two implementations under the near-tie rule of
``repro_torch.kernels.ref.near_tie_check``; schedules and ids of one
implementation along two routes: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_model_parity import (assert_close, bf16_close, ids_held,
                                 teacher_forced, to_jax_cache)
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.models import transformer as JT
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import value_and_grad
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ModelCallConfig, build
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

ARCH = "qwen3-4b"
SWA = "qwen3-4b-swa"
SWA_REDUCED = dict(sliding_window=8)
B, S, G = 2, 16, 32
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab_size", "head_dim", "qk_norm", "qkv_bias",
          "rope_theta", "sliding_window", "norm_eps", "act",
          "tie_embeddings", "source", "is_attention_free",
          "hybrid_attn_every")


# --------------------------------------------------------------------------- #
# config, variant and init
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", [ARCH, SWA])
def test_config_matches_reference(arch):
    for reduced in (False, True):
        j, c = jget_config(arch, reduced=reduced), get_config(
            arch, reduced=reduced)
        for f in FIELDS:
            assert getattr(c, f) == getattr(j, f), f
        assert c.ssm is None and j.ssm is None
        assert c.param_count() == j.param_count()
    assert get_config(arch).param_count() == 4_411_415_040
    assert get_config(SWA).sliding_window == 8192
    assert get_config(SWA, reduced=True) is get_config(ARCH, reduced=True)


def test_swa_gives_every_layer_its_window():
    """``layer_windows`` gives each of qwen3-4b-swa's 36 layers the one
    window, as the reference's; qwen3-4b's are all global; a forced
    window (``decode_window``) overrides both."""
    for arch in (ARCH, SWA):
        cfg, jcfg = get_config(arch), jget_config(arch)
        want = np.asarray(JT.layer_windows(jcfg, cfg.n_layers)).tolist()
        assert T.layer_windows(cfg, cfg.n_layers) == want
        assert T.layer_windows(cfg, cfg.n_layers, 512) == np.asarray(
            JT.layer_windows(jcfg, cfg.n_layers, 512)).tolist()
    assert T.layer_windows(get_config(SWA), 36) == [8192] * 36


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_tree_matches_reference_layout(reduced):
    """The port's init has the reference's tree paths and shapes, q_norm
    and k_norm included. Full width is read from the reference's abstract
    init only (4,419,943,936 parameters) and from the port's init under
    ``FakeTensorMode`` (no storage)."""
    jcfg, cfg = jget_config(ARCH, reduced=reduced), get_config(
        ARCH, reduced=reduced)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    if reduced:
        tp = build(cfg).init(torch.Generator().manual_seed(0))
    else:
        assert sum(int(np.prod(s)) for _, s in want) == 4_419_943_936
        with FakeTensorMode():
            tp = build(cfg).init(torch.Generator())
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want
    assert "q_norm" in tp["blocks"]["stack"]["attn"]


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=[False, True], ids=["qwen3", "swa"])
def setup(request):
    """Reduced qwen3 (global attention) and the same with an 8-token
    sliding window; a 24-token batch, so the window masks."""
    extra = SWA_REDUCED if request.param else {}
    jcfg = jget_config(ARCH, reduced=True).replace(**extra)
    cfg = get_config(ARCH, reduced=True).replace(**extra)
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
    assert any("q_norm" in k for k in tgd)
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


def test_logits_and_prefill_cache_match_reference(setup):
    """``logits``, ``prefill`` and ``prefill_cache``: logits to 1e-5, the
    bf16 K/V cache at the bf16 bound; the raw cache is (L, B, S, Hk, hd)."""
    jcfg, cfg, jp, toks, labs = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    jb, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    jpa = jax.tree.map(jnp.asarray, jp)
    with torch.inference_mode():
        lg = tm.logits(tp, tb)
        l0, raw = tm.prefill(tp, tb)
        l1, cache = tm.prefill_cache(tp, tb, 40)
    assert_close(lg.numpy(), jm.logits(jpa, jb), 1e-5, "logits")
    jl, jc = jm.prefill_cache(jpa, jb, 40)
    assert_close(l1.numpy(), jl, 1e-5, "last logits")
    assert torch.equal(l0, l1)
    assert raw["stack"][0].shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads,
                                     cfg.head_dim)
    for key in ("k", "v"):
        assert cache[key].dtype == torch.bfloat16
        bf16_close(cache[key], jc[key], 1e-5, key)


def test_kernel_routes_equal_plain_routes_on_cpu(setup):
    """``use_flash_kernel`` (K4's plain version on the CPU; with the
    sliding window K4 does not apply and the dense route runs) gives the
    plain route's logits and cache; ``loss`` differentiated with it raises
    where K4 runs (forward-only)."""
    _, cfg, jp, toks, labs = setup
    tp = params_from_jax(jp, "cpu")
    _, tb = _batches(toks, labs)
    plain = build(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_flash_kernel=True))
    with torch.inference_mode():
        lp, cp = plain.prefill_cache(tp, tb, 40)
        lk, ck = kern.prefill_cache(tp, tb, 40)
    assert_close(lk.numpy(), lp.numpy(), 1e-5, "last logits")
    for key in ("k", "v"):
        bf16_close(ck[key], cp[key].float().numpy(), 1e-5, key)
    if cfg.sliding_window:
        value_and_grad(kern.loss)(tp, tb)         # the dense route
    else:
        with pytest.raises(ValueError, match="forward-only"):
            value_and_grad(kern.loss)(tp, tb)


def test_flash_kernel_runs_once_a_layer_without_a_window(setup,
                                                          monkeypatch):
    _, cfg, jp, toks, labs = setup
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    _, tb = _batches(toks, labs)
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_flash_kernel=True))
    with torch.inference_mode():
        kern.prefill_cache(params_from_jax(jp, "cpu"), tb, 40)
    want = 0 if cfg.sliding_window else cfg.n_layers
    assert len(calls) == want
    assert all(s == (2, 24, cfg.n_heads, cfg.head_dim) for s in calls)


# --------------------------------------------------------------------------- #
# decode: teacher-forced steps, the window, the ring
# --------------------------------------------------------------------------- #


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
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_teacher_forced_decode_from_reference_cache(setup, pos_kind, kernel,
                                                    window):
    """32 steps from the reference's prefill cache
    (``_torch_model_parity.teacher_forced``): each step from the
    reference's cache, the updated K/V, the logits and the
    ``decode_sample`` ids held. ``kernel`` runs K5 and K6 (their plain
    versions on the CPU); ``ring`` decodes through a 12-slot ring buffer
    that the 16-token prompt has already wrapped; with the swa setup the
    model's 8-token window masks every step."""
    jcfg, cfg, jp, _, _ = setup
    tp = params_from_jax(jp, "cpu")
    jm, tm = _models(jcfg, cfg, window, use_decode_kernel=kernel)
    jb, _ = _prompt(cfg)
    assert teacher_forced(jm, tm, jp, tp, jb, S, G, pos_kind) <= 1


@pytest.mark.parametrize("window", [8, 12, 16], ids=["S>C=W", "S>C",
                                                     "S=C"])
def test_prefill_cache_ring_matches_reference(setup, window):
    """``init_cache`` and ``prefill_cache`` under ``decode_window``: a
    C-slot ring (C = the window) holding the last C positions at slot
    pos % C, as the reference places them, at the bf16 bound; the last
    logits to 1e-5."""
    jcfg, cfg, jp, _, _ = setup
    tp = params_from_jax(jp, "cpu")
    jm, tm = _models(jcfg, cfg, window)
    jc0 = jm.init_cache(B, S + G)
    tc0 = tm.init_cache(B, S + G, "cpu")
    for key in ("k", "v"):
        assert tuple(tc0[key].shape) == jc0[key].shape
        assert tc0[key].shape[2] == window
    jb, tb = _prompt(cfg)
    jl, jc = jax.jit(jm.prefill_cache, static_argnums=2)(jp, jb, S + G)
    with torch.inference_mode():
        tl, tc = tm.prefill_cache(tp, tb, S + G)
    assert_close(tl, jl, 1e-5, "last logits")
    for key in ("k", "v"):
        bf16_close(tc[key], jc[key], 1e-5, key)


def test_reference_decodes_from_the_port_prefill_cache(setup):
    jcfg, cfg, jp, _, _ = setup
    tp = params_from_jax(jp, "cpu")
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


# --------------------------------------------------------------------------- #
# the serve entry points and one training round against the reference
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    return jcfg, get_config(ARCH, reduced=True), jp, params_from_jax(
        jax.device_get(jp), "cpu")


@pytest.mark.parametrize("arch", [ARCH, SWA])
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_replays_the_reference(served, kernel, arch):
    """``serve`` on the reference's weights and prompt gives the
    reference's greedy ids under the near-tie rule; ``kernel`` runs the
    prefill on K4's route and the decode on K5's and K6's (their plain
    versions on the CPU)."""
    jcfg, cfg, jp, tp = served
    jb, tb = _prompt(cfg, seed=7)
    want = jserve.serve(arch, reduced=True, batch=B, prompt_len=S,
                        gen_len=12, seed=0, prompt=jb, verbose=False)
    got = serve.serve(arch, batch=B, prompt_len=S, gen_len=12, seed=0,
                      prompt=tb, params=tp, use_flash_kernel=kernel,
                      use_decode_kernel=kernel, verbose=False, device="cpu")
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
    """``serve_continuous`` against the reference's on one trace, its
    seed-0 weights and the same prompts (the reference's ``request_prompt``
    is salted per process, so both get the port's): the schedule exactly,
    every request's ids under the near-tie rule; with ``kernel`` through
    K4, K5 and K6 (plain versions on the CPU)."""
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


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
def test_savic_round_matches_the_reference(served, fused):
    """One savic round of reduced qwen3 through ``train.main`` (tree loop,
    and the fused loop on K1's plain version) from the reference's
    weights, against the reference's ``train.main``: loss and drift to
    1e-5 relative (the dense engine tests' tolerance)."""
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
