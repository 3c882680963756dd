"""The port's gemma3-4b (dense, 5 local layers with a sliding window of 1024
to 1 global layer, GQA 8/4 at d_head 256, qk-norm, GeGLU, a tied head
scaled by d^-½) held against the reference, on the reduced config with the
reference's weights carried across by ``repro_torch.bridge``: config,
``param_count`` and the window schedule at full and reduced depth, the init
tree, loss and every gradient, logits, the prefill cache, a teacher-forced
32-step decode, the kernel routes (K4 with each layer's window, K5, K6:
their plain versions on the CPU) against the plain ones, the serve entry
points' ids, and one savic round through ``train.main``.

The reduced config has 2 layers at ``local_global_ratio`` 1: layer 0 local
(window 64), layer 1 global. The model tests run it on 96-token prompts,
so the window masks, and again at d_head 256 on both sides
(``D256``), so the model path crosses the kernels' D = 256 contracts.

Tolerances, those of ``tests/test_torch_qwen3.py``, and why: fp32 loss,
logits and gradients to 1e-5 of their largest magnitude (the two
frameworks' matmuls and reductions add in other orders); bf16 to 1e-2
(loss) and 5e-2 (each gradient leaf's largest magnitude), where the
frameworks round at different places; the bf16 K/V cache to 1e-5 of its
largest value plus the two roundings to bf16 (2^-7 of the element);
decode logits from one carried cache to 1e-5, 1e-3 where the step's own
K/V rounded to neighbouring bf16 values on the two sides, at most three
quarters of the steps, ids then held to the port's own logits; ids of two
implementations under the near-tie rule of
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
from repro_torch.models.flash import HUGE_WINDOW
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

ARCH = "gemma3-4b"
D256 = dict(d_head=256)
B, S, G = 2, 96, 32
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab_size", "head_dim", "qk_norm", "qkv_bias",
          "rope_theta", "sliding_window", "local_global_ratio",
          "logit_softcap", "norm_eps", "act", "tie_embeddings", "source",
          "is_attention_free", "hybrid_attn_every")


# --------------------------------------------------------------------------- #
# config, windows and init
# --------------------------------------------------------------------------- #


def test_config_matches_reference():
    for reduced in (False, True):
        j, c = jget_config(ARCH, reduced=reduced), get_config(
            ARCH, reduced=reduced)
        for f in FIELDS:
            assert getattr(c, f) == getattr(j, f), f
        assert c.ssm is None and j.ssm is None
        assert c.param_count() == j.param_count()
    assert get_config(ARCH).param_count() == 3_879_907_840
    assert get_config(ARCH).logit_softcap == 0.0


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_layer_windows_match_reference(reduced):
    """The 5:1 schedule: global layers exactly at 5, 11, 17, 23 and 29 of
    34 (the reduced model's 1:1: layer 1 of 2), the rest at the sliding
    window; a forced window (``decode_window``) overrides both; as the
    reference's ``layer_windows``."""
    cfg, jcfg = get_config(ARCH, reduced), jget_config(ARCH, reduced)
    L = cfg.n_layers
    for force in (0, 512):
        want = np.asarray(JT.layer_windows(jcfg, L, force)).tolist()
        assert T.layer_windows(cfg, L, force) == want
    wins = T.layer_windows(cfg, L)
    glob = [i for i, w in enumerate(wins) if w == HUGE_WINDOW]
    assert glob == ([5, 11, 17, 23, 29] if not reduced else [1])
    assert all(w == cfg.sliding_window for i, w in enumerate(wins)
               if i not in glob)
    assert T.layer_windows(cfg.replace(local_global_ratio=0), L) == \
        [cfg.sliding_window] * L
    assert T.layer_windows(cfg.replace(sliding_window=0), L) == \
        [HUGE_WINDOW] * L


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_tree_matches_reference_layout(reduced):
    """The port's init has the reference's tree paths and shapes: q_norm
    and k_norm, no ``head`` leaf (the tied table). Full width is read from
    the reference's abstract init only (3,879,925,248 parameters:
    ``param_count``'s 3,879,907,840 and the 34 × 2 qk-norm scales of 256,
    which it leaves out) and from the port's init under ``FakeTensorMode``
    (no storage)."""
    jcfg, cfg = jget_config(ARCH, reduced=reduced), get_config(
        ARCH, reduced=reduced)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    if reduced:
        tp = build(cfg).init(torch.Generator().manual_seed(0))
    else:
        assert sum(int(np.prod(s)) for _, s in want) == 3_879_925_248
        with FakeTensorMode():
            tp = build(cfg).init(torch.Generator())
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want
    assert "q_norm" in tp["blocks"]["stack"]["attn"]
    assert "head" not in tp["embed"]


def test_sample_head_is_the_tied_table():
    """K6's operand is the tied table itself (no (V, d) copy: 2.7 GB at
    full width) with the d^-½ scale of the reference's tied head."""
    cfg = get_config(ARCH, reduced=True)
    m = build(cfg, ModelCallConfig(dtype=torch.float32,
                                   use_decode_kernel=True))
    params = m.init(torch.Generator().manual_seed(0))
    table, scale = m.sample_head(params)
    assert table.data_ptr() == params["embed"]["table"].data_ptr()
    assert scale == cfg.d_model ** -0.5


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=[False, True], ids=["gemma3", "d256"])
def setup(request):
    """Reduced gemma3 (layer 0 local with a 64-token window, layer 1
    global), and the same at d_head 256; a 96-token batch, so the window
    masks."""
    extra = D256 if request.param else {}
    jcfg = jget_config(ARCH, reduced=True).replace(**extra)
    cfg = get_config(ARCH, reduced=True).replace(**extra)
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
    assert any("k_norm" in k for k in tgd)
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
    bf16 K/V cache of every layer (local and global) at the bf16 bound,
    the whole 96-position prompt kept; the raw cache is (L, B, S, Hk,
    hd)."""
    jcfg, cfg, jp, toks, labs = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    jb, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    jpa = jax.tree.map(jnp.asarray, jp)
    with torch.inference_mode():
        lg = tm.logits(tp, tb)
        l0, raw = tm.prefill(tp, tb)
        l1, cache = tm.prefill_cache(tp, tb, S + G)
    assert_close(lg.numpy(), jm.logits(jpa, jb), 1e-5, "logits")
    jl, jc = jm.prefill_cache(jpa, jb, S + G)
    assert_close(l1.numpy(), jl, 1e-5, "last logits")
    assert torch.equal(l0, l1)
    assert raw["stack"][0].shape == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                     cfg.head_dim)
    for key in ("k", "v"):
        assert cache[key].shape == (cfg.n_layers, B, S + G, cfg.n_kv_heads,
                                    cfg.head_dim)
        assert cache[key].dtype == torch.bfloat16
        bf16_close(cache[key], jc[key], 1e-5, key)


def test_kernel_routes_equal_plain_routes_on_cpu(setup):
    """``use_flash_kernel`` (K4's plain version on the CPU, with the local
    layer's window of 64 and the global layer's none) gives the plain
    route's logits and cache; ``loss`` differentiated with it raises
    (forward-only), and equals the plain loss without grad."""
    _, cfg, jp, toks, labs = setup
    tp = params_from_jax(jp, "cpu")
    _, tb = _batches(toks, labs)
    plain = build(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_flash_kernel=True))
    with torch.inference_mode():
        lp, cp = plain.prefill_cache(tp, tb, S + G)
        lk, ck = kern.prefill_cache(tp, tb, S + G)
        lossp, lossk = plain.loss(tp, tb), kern.loss(tp, tb)
    assert_close(lk.numpy(), lp.numpy(), 1e-5, "last logits")
    for key in ("k", "v"):
        bf16_close(ck[key], cp[key].float().numpy(), 1e-5, key)
    np.testing.assert_allclose(float(lossk), float(lossp), rtol=1e-5)
    with pytest.raises(ValueError, match="forward-only"):
        value_and_grad(kern.loss)(tp, tb)


def test_flash_kernel_runs_once_a_layer_with_its_window(setup, monkeypatch):
    """K4 runs once a layer, given the local layer's window and no window
    (0) on the global one, at the model's head dim."""
    _, cfg, jp, toks, labs = setup
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    _, tb = _batches(toks, labs)
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_flash_kernel=True))
    with torch.inference_mode():
        kern.prefill_cache(params_from_jax(jp, "cpu"), tb, S + G)
    shape = (B, S, cfg.n_heads, cfg.head_dim)
    assert calls == [(shape, cfg.sliding_window), (shape, 0)]


# --------------------------------------------------------------------------- #
# decode: teacher-forced steps past the window
# --------------------------------------------------------------------------- #


def _prompt(cfg, b=B, s=S, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks)})


def _models(jcfg, cfg, **kw):
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, **kw))
    return jm, tm


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_teacher_forced_decode_from_reference_cache(setup, pos_kind,
                                                    kernel):
    """32 steps from the reference's prefill cache of a 96-token prompt
    (``_torch_model_parity.teacher_forced``): each step from the
    reference's cache, the updated K/V, the logits and the
    ``decode_sample`` ids held; the local layer's 64-token window masks
    every step's bias, the global layer's none. ``kernel`` runs K5 and K6
    (their plain versions on the CPU). The cache is held layer by layer:
    layer 1 attends to layer 0's new K/V in the same step, so where those
    rounded apart on the two sides, layer 1's new K/V are held as that
    step's logits are. At d_head 256 a step rounds eight times the new K/V
    values it rounds at 32, and 31 of the 32 steps have one that rounds
    apart (4 at 32), so the cap of three quarters of such steps is not
    applied there."""
    jcfg, cfg, jp, _, _ = setup
    tp = params_from_jax(jp, "cpu")
    jm, tm = _models(jcfg, cfg, use_decode_kernel=kernel)
    jb, _ = _prompt(cfg)
    cap = G if cfg.head_dim == 256 else None
    n = teacher_forced(jm, tm, jp, tp, jb, S, G, pos_kind, layered=True,
                       max_flipped=cap)
    assert n <= 1


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


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_replays_the_reference(served, kernel):
    """``serve`` of a 96-token prompt on the reference's weights gives the
    reference's greedy ids under the near-tie rule; ``kernel`` runs the
    prefill on K4's route (each layer's window) and the decode on K5's and
    K6's (their plain versions on the CPU; K6 reads the tied table)."""
    jcfg, cfg, jp, tp = served
    jb, tb = _prompt(cfg, seed=7)
    want = jserve.serve(ARCH, reduced=True, batch=B, prompt_len=S,
                        gen_len=12, seed=0, prompt=jb, verbose=False)
    got = serve.serve(ARCH, batch=B, prompt_len=S, gen_len=12, seed=0,
                      prompt=tb, params=tp, use_flash_kernel=kernel,
                      use_decode_kernel=kernel, verbose=False, device="cpu")
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    assert ids_held(tm, tp, tb, got.tokens, np.asarray(want.tokens),
                    S) <= 1


TRACE = dict(reduced=True, slots=3, n_requests=6, prompt_len=72, gen_len=6,
             arrival_rate=0.7, seed=0, verbose=False)
SCHEDULE_METRICS = ("n_requests", "slots", "total_tokens", "makespan_steps",
                    "tok_per_step", "decode_steps", "mean_queue_delay_steps",
                    "max_queue_delay_steps")


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_continuous_matches_the_reference(served, monkeypatch, kernel):
    """``serve_continuous`` against the reference's on one trace of
    72-token prompts (past the 64 window), its seed-0 weights and the same
    prompts (the reference's ``request_prompt`` is salted per process, so
    both get the port's): the schedule exactly, every request's ids under
    the near-tie rule; with ``kernel`` through K4, K5 and K6 (plain
    versions on the CPU)."""
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
    """One savic round of reduced gemma3 on 96-token sequences through
    ``train.main`` (tree loop, and the fused loop on K1's plain version)
    from the reference's weights, against the reference's ``train.main``:
    loss and drift to 1e-5 relative (the dense engine tests'
    tolerance)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    _, _, jp, _ = served
    argv = ["--arch", ARCH, "--reduced", "--method", "savic", "--rounds",
            "1", "--h-local", "2", "--clients", "2", "--batch", "2",
            "--seq", str(S)]
    want = jtrain.main(argv)
    np_params = jax.device_get(jp)
    got = train.main(argv + ["--device", "cpu"]
                     + (["--use-fused-kernel"] if fused else []),
                     init_params=lambda g: params_from_jax(np_params,
                                                           g.device))
    for k in ("loss", "drift"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5)
