"""The port's audio and vlm families held against the reference, on the
reduced configs with the reference's weights carried across by
``repro_torch.bridge``: musicgen-large (audio: frame embeddings replace the
token embeddings 1:1; GeGLU; an untied head) and internvl2-1b (vlm: patch
embeddings prepended to the text, the labels -1 over them; qwen2's GQA with
QKV bias; a tied table). Held: config and ``param_count``, the init tree
(full width under ``FakeTensorMode``), ``batch_struct`` and
``sample_batch``, loss and every gradient, logits and the prefill cache on
``embeds`` / ``patches`` batches, the kernel routes (K4, K5, K6: their
plain versions on the CPU), a teacher-forced 8-step decode from the
reference's cache, the decode cache as a fixed point of a step,
``train._wrap_modal`` against the reference's, two savic rounds through
``train.main``, and the serve entry points' ids.

Both families are dense stacks: their frontends are stubs that feed the
residual stream (``models/model.py``'s ``_residual_input``); decode feeds
token ids in both.

Tolerances, and why: fp32 loss, logits and gradients to 1e-5 of their
largest magnitude (the dense tests': the frameworks' matmuls and
reductions add in other orders); bf16 loss to 1e-2, where the frameworks
round at different places; the bf16 K/V cache to 1e-5 of its largest value
plus the two roundings to bf16; decode logits from one carried cache as
``_torch_model_parity.teacher_forced`` holds them (1e-5; 1e-3 where a
step's own bf16 K/V rounded apart); the two-round savic log to 1e-4 (two
rounds of updates carry the first round's 1e-5 differences on); ids of two
implementations under the near-tie rule; ``_wrap_modal``'s arrays, the
schedules and the ids of one implementation along two routes: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_model_parity import (assert_close, bf16_close, ids_held,
                                 teacher_forced)
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import ModelCallConfig as JCall
from repro.models import batch_struct as jbatch_struct
from repro.models import build as jbuild
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import value_and_grad
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import (ModelCallConfig, batch_struct, build,
                                sample_batch)
from repro_torch.models.layers import cross_entropy
from repro_torch.utils import rng
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

AUDIO, VLM = "musicgen-large", "internvl2-1b"
ARCHS = [AUDIO, VLM]
B, S, G = 2, 24, 8
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab_size", "head_dim", "qkv_bias", "rope_theta",
          "norm_eps", "act", "tie_embeddings", "source", "frontend_tokens",
          "frontend_kind", "is_attention_free")
PARAMS = {AUDIO: 3_229_812_736, VLM: 493_753_344}


# --------------------------------------------------------------------------- #
# config, init, batch specs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for reduced in (False, True):
        j, c = jget_config(arch, reduced), get_config(arch, reduced)
        for f in FIELDS:
            assert getattr(c, f) == getattr(j, f), f
        assert c.moe is None and c.mla is None and c.ssm is None
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
    assert get_config(arch).param_count() == PARAMS[arch]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_layout(arch, reduced):
    """The port's init has the reference's tree paths and shapes (a dense
    stack; the tied vlm keeps no head). Full width is read from the port's
    init under ``FakeTensorMode``."""
    jcfg, cfg = jget_config(arch, reduced), get_config(arch, reduced)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    if reduced:
        tp = build(cfg).init(torch.Generator().manual_seed(0))
    else:
        with FakeTensorMode():
            tp = build(cfg).init(torch.Generator())
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want
    assert ("embed/head" in dict(got)) == (arch == AUDIO)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_struct_matches_reference(arch, reduced):
    """The batch fields, shapes and dtypes of the reference's
    ``batch_struct``: audio embeddings (B, S, d) fp32 and labels; vlm
    patches (B, P, d) fp32 and S - P text tokens and labels. ``sample_batch``
    draws them from the stream (embeddings standard normal), the same
    numbers from the same stream."""
    cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
    seq = 300 if not reduced else S
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            jbatch_struct(jcfg, 3, seq).items()}
    got = {k: (shape, str(dt).replace("torch.", "")) for k, (shape, dt) in
           batch_struct(cfg, 3, seq).items()}
    assert got == want
    if reduced:
        a = sample_batch(cfg, rng.TorchStream(4), 3, seq, "cpu")
        b = sample_batch(cfg, rng.TorchStream(4), 3, seq, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in a.items()} == want
        for k in a:
            assert torch.equal(a[k], b[k])
        emb = a["embeds" if arch == AUDIO else "patches"]
        assert abs(float(emb.std()) - 1.0) < 0.1
        ids = a["labels"]
        assert 0 <= int(ids.min()) and int(ids.max()) < cfg.vocab_size


# --------------------------------------------------------------------------- #
# loss, gradients, logits, the prefill cache
# --------------------------------------------------------------------------- #


def _np_batch(cfg, b=B, s=S, seed=0, labels=True):
    """A numpy batch of ``s`` residual positions for the family."""
    r = np.random.default_rng(seed)
    d = cfg.d_model
    ids = lambda n: r.integers(0, cfg.vocab_size, size=(b, n)).astype(
        np.int32)
    if cfg.family == "audio":
        out = {"embeds": r.standard_normal((b, s, d)).astype(np.float32)}
        n = s
    else:
        P = cfg.frontend_tokens
        out = {"patches": r.standard_normal((b, P, d)).astype(np.float32),
               "tokens": ids(s - P)}
        n = s - P
    if labels:
        lab = ids(n)
        lab[0, :3] = -1
        out["labels"] = lab
    return out


def _batches(nb):
    to_t = lambda k, v: torch.from_numpy(v).long() if v.dtype == np.int32 \
        else torch.from_numpy(v)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: to_t(k, v) for k, v in nb.items()})


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch,
                                                           reduced=True)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    return arch, jcfg, cfg, jp, _np_batch(cfg)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(setup, remat):
    """Loss and every gradient to 1e-5 on an ``embeds`` (audio) or
    ``patches`` + tokens (vlm) batch."""
    _, jcfg, cfg, jp, nb = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, remat=remat))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat))
    jb, tb = _batches(nb)
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jgd = dict(jtree_paths(jax.device_get(jg)))
    tgd = dict(tree_paths(tg))
    assert tgd.keys() == jgd.keys()
    for k, want in jgd.items():
        assert_close(tgd[k].numpy(), want, 1e-5, k)


def test_loss_matches_reference_bf16(setup):
    _, jcfg, cfg, jp, nb = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.bfloat16))
    tm = build(cfg, ModelCallConfig(dtype=torch.bfloat16))
    jb, tb = _batches(nb)
    jl = jm.loss(jax.tree.map(jnp.asarray, jp), jb)
    with torch.no_grad():
        tl = tm.loss(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)


def test_loss_counts_the_text_positions_only(setup):
    """The vlm's loss is the cross entropy of its text positions (labels -1
    over the patches); the audio's of every frame: ``loss`` equals the
    cross entropy of ``logits`` over those positions."""
    arch, _, cfg, jp, nb = setup
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    tp = params_from_jax(jp, "cpu")
    _, tb = _batches(nb)
    with torch.no_grad():
        lg = tm.logits(tp, tb)
        loss = tm.loss(tp, tb)
    assert lg.shape == (B, S, lg.shape[-1])
    P = cfg.frontend_tokens if arch == VLM else 0
    want = cross_entropy(lg[:, P:], tb["labels"], cfg.vocab_size)
    assert torch.allclose(loss, want, rtol=1e-6, atol=0.0)


def test_logits_and_prefill_cache_match_reference(setup):
    """``logits`` (every residual position, the patches' included) and
    ``prefill_cache`` to 1e-5, the bf16 K/V cache at the bf16 bound; a
    prompt needs no labels."""
    _, jcfg, cfg, jp, nb = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    jb, tb = _batches(nb)
    tp = params_from_jax(jp, "cpu")
    jpa = jax.tree.map(jnp.asarray, jp)
    want_lg = jm.logits(jpa, jb)
    jl, jc = jm.prefill_cache(jpa, jb, S + G)
    prompt = {k: v for k, v in tb.items() if k != "labels"}
    with torch.inference_mode():
        lg = tm.logits(tp, tb)
        l1, cache = tm.prefill_cache(tp, prompt, S + G)
    assert_close(lg.numpy(), want_lg, 1e-5, "logits")
    assert_close(l1.numpy(), jl, 1e-5, "last logits")
    assert sorted(cache) == sorted(jc) == ["k", "v"]
    for key in cache:
        assert cache[key].shape == (cfg.n_layers, B, S + G, cfg.n_kv_heads,
                                    cfg.head_dim)
        bf16_close(cache[key], jc[key], 1e-5, key)


def test_kernel_routes_equal_plain_routes_on_cpu(setup, monkeypatch):
    """``use_flash_kernel`` (K4's plain version on the CPU, one call a
    layer) gives the plain route's logits and cache."""
    _, _, cfg, jp, nb = setup
    tp = params_from_jax(jp, "cpu")
    _, tb = _batches(nb)
    plain = build(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_flash_kernel=True))
    calls, real = [], ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.inference_mode():
        lp, cp = plain.prefill_cache(tp, tb, S + G)
        lk, ck = kern.prefill_cache(tp, tb, S + G)
    assert len(calls) == cfg.n_layers
    assert_close(lk.numpy(), lp.numpy(), 1e-5, "last logits")
    for key in cp:
        bf16_close(ck[key], cp[key].float().numpy(), 1e-5, key)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_teacher_forced_decode_from_reference_cache(setup, pos_kind,
                                                    kernel):
    """8 steps after an ``embeds`` / ``patches`` prompt, from the
    reference's prefill cache (``_torch_model_parity.teacher_forced``);
    ``kernel`` runs K5 and K6 (plain versions on the CPU)."""
    _, jcfg, cfg, jp, nb = setup
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32,
                                    use_decode_kernel=kernel))
    jb, _ = _batches(_np_batch(cfg, seed=1))
    assert teacher_forced(jm, tm, jp, params_from_jax(jp, "cpu"), jb, S, G,
                          pos_kind) <= 1


def test_decode_cache_is_dtype_and_shape_fixed_point(setup):
    """One decode step (per-slot positions) returns the cache of
    ``init_cache``, leaf for leaf in shape and dtype, the reference's."""
    _, jcfg, cfg, jp, _ = setup
    jcache = jbuild(jcfg, JCall(dtype=jnp.float32)).init_cache(2, 12)
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in
            jtree_paths(jcache)}
    shapes = lambda c: {p: (tuple(x.shape), str(x.dtype).replace(
        "torch.", "")) for p, x in tree_paths(c)}
    cache = tm.init_cache(2, 12, "cpu")
    assert shapes(cache) == want
    with torch.inference_mode():
        _, c2 = tm.decode(params_from_jax(jp, "cpu"), cache,
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    assert shapes(c2) == want


# --------------------------------------------------------------------------- #
# training: the modal stubs and two savic rounds
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("labeled", [False, True], ids=["plain", "labeled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_wrap_modal_is_bitwise_the_reference(arch, labeled):
    """``train._wrap_modal`` gives the reference's arrays bit for bit (its
    ``default_rng((seed, r, 1))`` draws), for several seeds and rounds,
    with and without the ``labeled`` mask."""
    cfg, jcfg = get_config(arch, True), jget_config(arch, True)
    r = np.random.default_rng(2)
    nb = {"tokens": r.integers(0, 100, (2, 3, 2, 32)).astype(np.int32),
          "labels": r.integers(0, 100, (2, 3, 2, 32)).astype(np.int32)}
    if labeled:
        nb["labeled"] = (r.random((2, 3, 2)) < 0.5).astype(np.float32)
    for seed, rnd in ((0, 0), (0, 1), (3, 7)):
        want = jtrain._wrap_modal(jcfg, nb, seed, rnd)
        got = train._wrap_modal(cfg, nb, seed, rnd)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    assert train._wrap_modal(cfg, nb, 0, 0)[
        "embeds" if arch == AUDIO else "patches"].dtype == np.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_round_batch_wraps_the_modal_families(arch):
    """``train.round_batch`` hands the engine the wrapped round batch: fp32
    embeddings, int64 ids, the vlm's text cut to seq - P."""
    args = train._parser().parse_args(["--arch", arch, "--reduced",
                                       "--clients", "2", "--h-local", "2",
                                       "--batch", "2", "--seq", "32",
                                       "--device", "cpu"])
    cfg = get_config(arch, True)
    from repro_torch.data import LMRoundLoader, TokenStream
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=0), 2, 2, seed=0)
    b = train.round_batch(loader, args, 1, torch.device("cpu"))
    d = cfg.d_model
    if arch == AUDIO:
        assert sorted(b) == ["embeds", "labels"]
        assert b["embeds"].shape == (2, 2, 2, 32, d)
        assert b["embeds"].dtype == torch.float32
    else:
        P = cfg.frontend_tokens
        assert sorted(b) == ["labels", "patches", "tokens"]
        assert b["patches"].shape == (2, 2, 2, P, d)
        assert b["tokens"].shape == (2, 2, 2, 32 - P)
        assert b["tokens"].dtype == torch.long


@pytest.mark.parametrize("arch", ARCHS)
def test_savic_two_rounds_match_the_reference(arch):
    """Two savic rounds of the reduced frontend arch through ``train.main``
    (the modal stubs around each round's tokens) from the reference's
    weights, against the reference's ``train.main``: loss and drift of
    both rounds to 1e-4 relative."""
    argv = ["--arch", arch, "--reduced", "--method", "savic", "--rounds",
            "2", "--h-local", "2", "--clients", "2", "--batch", "2",
            "--seq", "32"]
    want = jtrain.main(argv)
    jcfg = jget_config(arch, reduced=True)
    np_params = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    got = train.main(argv + ["--device", "cpu"],
                     init_params=lambda g: params_from_jax(np_params,
                                                           g.device))
    assert len(got) == len(want) == 2
    for r in range(2):
        for k in ("loss", "drift"):
            np.testing.assert_allclose(got[r][k], want[r][k], rtol=1e-4)


# --------------------------------------------------------------------------- #
# the serve entry points
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    arch = request.param
    jcfg = jget_config(arch, reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    return arch, get_config(arch, reduced=True), params_from_jax(
        jax.device_get(jp), "cpu")


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_replays_the_reference(served, kernel):
    """``serve`` with an embedding prompt (frames; patches + text) gives
    the reference's greedy ids under the near-tie rule (held on the port's
    plain logits); ``kernel`` runs K4, K5 and K6 (plain versions on the
    CPU)."""
    arch, cfg, tp = served
    jb, tb = _batches(_np_batch(cfg, seed=7))
    want = jserve.serve(arch, reduced=True, batch=B, prompt_len=S,
                        gen_len=8, seed=0, prompt=jb, verbose=False)
    got = serve.serve(arch, batch=B, prompt_len=S, gen_len=8, seed=0,
                      prompt=tb, params=tp, use_flash_kernel=kernel,
                      use_decode_kernel=kernel, verbose=False, device="cpu")
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    assert ids_held(tm, tp, tb, got.tokens, np.asarray(want.tokens),
                    S) <= 1


TRACE = dict(reduced=True, slots=3, n_requests=6, prompt_len=S, gen_len=6,
             arrival_rate=0.7, seed=0, verbose=False)
SCHEDULE_METRICS = ("n_requests", "slots", "total_tokens", "makespan_steps",
                    "tok_per_step", "decode_steps", "mean_queue_delay_steps",
                    "max_queue_delay_steps")


def test_continuous_matches_the_reference(served, monkeypatch):
    """``serve_continuous`` against the reference's on one trace and the
    same prompts (``request_prompt``'s embeddings; the reference's salts
    its draws per process, so both get the port's): the schedule exactly,
    every request's ids under the near-tie rule, through K4, K5 and K6."""
    arch, cfg, tp = served
    prompts = [serve.request_prompt(cfg, 0, r, S, "cpu")
               for r in range(TRACE["n_requests"])]
    assert sorted(prompts[0]) == sorted(batch_struct(cfg, 1, S))
    monkeypatch.setattr(jserve, "request_prompt", lambda c, s, r, n: {
        k: jnp.asarray(v.numpy()) for k, v in prompts[r].items()})
    want = jserve.serve_continuous(arch, **TRACE)
    got = serve.serve_continuous(arch, device="cpu", params=tp,
                                 prompts=prompts, use_flash_kernel=True,
                                 use_decode_kernel=True, **TRACE)
    assert got.requests == want.requests
    for key in SCHEDULE_METRICS:
        assert got.metrics[key] == want.metrics[key], key
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    ties = 0
    for r in range(TRACE["n_requests"]):
        g, w = got.tokens[r], np.asarray(want.tokens[r])
        assert g.shape == w.shape, r
        ties += ids_held(tm, tp, prompts[r], g[None], w[None], S)
    assert ties <= 1


def test_serve_replay_refuses_embedding_prompts(served):
    """``serve_replay`` feeds the prompt's ids token by token: the audio
    and vlm prompts carry embeddings, so it raises."""
    arch, _, tp = served
    with pytest.raises(ValueError, match="token ids"):
        serve.serve_replay(arch, batch=1, prompt_len=S, gen_len=2,
                           params=tp, verbose=False, device="cpu")


def test_serve_cli_runs_with_the_kernel_flags(served):
    arch, cfg, _ = served
    res = serve.main(["--arch", arch, "--device", "cpu", "--flash-kernel",
                      "--decode-kernel", "--batch", "2", "--prompt-len",
                      str(S), "--gen-len", "4"])
    assert res.tokens.shape == (2, 4)
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < \
        cfg.vocab_size
