"""The port's serving slice (prefill into a decode-ready cache, batched and
per-slot decode, the serve drivers) held against the reference on reduced
qwen2-0.5b, with the reference's weights carried across by
``repro_torch.bridge``.

Tolerances, and why:
* logits (prefill and teacher-forced decode): fp32, to 1e-5 of the largest
  logit magnitude (plus rtol 1e-5): the two frameworks' matmuls and
  reductions add in different orders.
* decode-cache leaves (bf16): within one bf16 ulp; two fp32 matmul orders
  can round to neighbouring bf16 values.
* ``_ring_place``, trace schedules and the Poisson trace: exact (indexing
  and numpy only).
* token ids of two implementations: the near-tie rule of
  ``repro_torch.kernels.ref.near_tie_check``; token streams of one
  implementation along two routes, and the sampled stream against the
  reference on replayed noise: exact.

The reference's ``sample_batch`` folds the per-process salted
``hash(name)`` into its key, so its prompts change from process to process;
prompts are handed to both sides as arrays here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rng_replay import JaxStream
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.models import transformer as JT
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import ModelCallConfig, build, sample_batch
from repro_torch.models import transformer as T
from repro_torch.utils import rng

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
B, S, G = 2, 8, 4


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    np_params = jax.device_get(jp)
    return jcfg, get_config(ARCH, reduced=True), jp, \
        params_from_jax(np_params, "cpu")


def _models(jcfg, cfg, **kw):
    jm = jbuild(jcfg, JCall(dtype=jnp.float32,
                            decode_window=kw.get("decode_window", 0)))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, **kw))
    return jm, tm


def _prompt(cfg, b=B, s=S, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks)})


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _bf16_ulps(a_t, b_np):
    """Largest distance in bf16 ulps between a torch bf16 tensor and a
    numpy bf16 array (monotone integer mapping of the 16-bit patterns)."""
    def key(bits):
        i = bits.astype(np.int64)
        return np.where(i & 0x8000, -(i & 0x7FFF), i)
    a = a_t.view(torch.int16).numpy().view(np.uint16)
    b = np.asarray(b_np).view(np.uint16)
    return int(np.abs(key(a) - key(b)).max())


def _to_jax_cache(cache):
    return {k: jnp.asarray(v.view(torch.int16).numpy().view(np.uint16)
                           .view(jnp.bfloat16)) for k, v in cache.items()}


@pytest.mark.parametrize("S_,C", [(5, 9), (8, 8), (12, 5)])
def test_ring_place_matches_reference(S_, C):
    src = np.random.default_rng(S_).normal(size=(2, 3, S_, 2, 4)) \
        .astype(np.float32)
    want = np.asarray(JT._ring_place(jnp.asarray(src), C, S_, axis=2))
    got = T._ring_place(torch.from_numpy(src), C, S_, axis=2).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [0, 8, 6], ids=["full", "S=C", "S>C"])
def test_prefill_and_cache_match_reference(weights, window):
    """``prefill`` and ``prefill_cache`` logits at fp32 tolerance; the
    decode-ready cache (ring-placed when the window is shorter than the
    prompt) within one bf16 ulp."""
    jcfg, cfg, jp, tp = weights
    jm, tm = _models(jcfg, cfg, decode_window=window)
    jb, tb = _prompt(cfg)
    with torch.inference_mode():
        tl, tcache = tm.prefill_cache(tp, tb, S + G)
        tl0, raw = tm.prefill(tp, tb)
    jl, jcache = jax.jit(jm.prefill_cache, static_argnums=2)(jp, jb, S + G)
    jl0, _ = jax.jit(jm.prefill)(jp, jb)
    _close_logits(tl, jl)
    _close_logits(tl0, jl0)
    assert torch.equal(tl, tl0)
    C = min(S + G, window) if window else S + G
    for key in ("k", "v"):
        assert tcache[key].shape == (cfg.n_layers, B, C, cfg.n_kv_heads,
                                     cfg.head_dim)
        assert tcache[key].dtype == torch.bfloat16
        assert _bf16_ulps(tcache[key], jcache[key]) <= 1
    assert raw["stack"][0].shape == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                     cfg.head_dim)


def _pos(kind, g):
    if kind == "scalar":
        return S + g, jnp.int32(S + g)
    p = np.array([S + g, S + g - 1], np.int32)      # slots at their own depth
    return torch.from_numpy(p), jnp.asarray(p)


@pytest.mark.parametrize("window", [0, 6], ids=["full", "ring"])
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_teacher_forced_decode_matches_reference(weights, pos_kind, kernel,
                                                 window):
    """From the reference's prefill cache, carried across: each step both
    models get the reference's greedy token; ``decode`` logits agree at fp32
    tolerance, ``decode_sample`` ids under the near-tie rule. ``kernel``
    routes the port through K5 and K6 (their plain versions on the CPU);
    ``ring`` decodes through a 6-slot ring buffer that the 8-token prompt
    has already wrapped (sliding-window mask, reconstructed key
    positions)."""
    jcfg, cfg, jp, tp = weights
    jm, tm = _models(jcfg, cfg, use_decode_kernel=kernel,
                     decode_window=window)
    jb, _ = _prompt(cfg)
    jl, jcache = jax.jit(jm.prefill_cache, static_argnums=2)(jp, jb, S + G)
    tcache = cache_from_jax(jax.device_get(jcache), "cpu")
    tcache2 = {k: v.clone() for k, v in tcache.items()}
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    jdecode = jax.jit(jm.decode)
    zeros = torch.zeros((B, jl.shape[-1]))
    ties = 0
    for g in range(G):
        tpos, jpos = _pos(pos_kind, g)
        ttok = torch.from_numpy(np.asarray(tok).copy())
        jl, jcache = jdecode(jp, jcache, tok, jpos)
        with torch.inference_mode():
            tl, tcache = tm.decode(tp, tcache, ttok, tpos)
            ids, tcache2 = tm.decode_sample(tp, tcache2, ttok, tpos, zeros)
        _close_logits(tl, jl)
        want = torch.from_numpy(
            np.asarray(jnp.argmax(jl[:, :cfg.vocab_size], -1)).copy())
        t, bad = ref.near_tie_check(tl, ids, want, cfg.vocab_size)
        assert bad == 0, g
        ties += t
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    assert ties <= 1
    for key in ("k", "v"):
        assert _bf16_ulps(tcache[key], jcache[key]) <= 1


def test_reference_decodes_from_the_port_prefill_cache(weights):
    """The other way round: the port's prefill cache, carried into the
    reference, decodes to the port's own logits."""
    jcfg, cfg, jp, tp = weights
    jm, tm = _models(jcfg, cfg)
    _, tb = _prompt(cfg)
    with torch.inference_mode():
        tl, tcache = tm.prefill_cache(tp, tb, S + G)
        jcache = _to_jax_cache(tcache)
        tok = torch.argmax(tl, -1).to(torch.int32)
        tl, tcache = tm.decode(tp, tcache, tok, S)
    jl, _ = jax.jit(jm.decode)(jp, jcache, jnp.asarray(tok.numpy()),
                               jnp.int32(S))
    _close_logits(tl, jl)


def test_per_slot_decode_bitwise_equals_scalar(weights):
    """decode with pos = full((B,), p) is bitwise the scalar-pos decode, and
    the cache is updated in place with its shapes and dtype."""
    _, cfg, _, tp = weights
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    _, tb = _prompt(cfg)
    with torch.inference_mode():
        _, cs = tm.prefill_cache(tp, tb, S + G)
        cv = {k: v.clone() for k, v in cs.items()}
        tok_s = tok_v = torch.zeros((B,), dtype=torch.int32)
        for g in range(G):
            ls, cs2 = tm.decode(tp, cs, tok_s, S + g)
            lv, cv2 = tm.decode(tp, cv, tok_v,
                                torch.full((B,), S + g, dtype=torch.int32))
            assert cs2 is cs and cv2 is cv
            assert torch.equal(ls, lv), g
            tok_s = tok_v = torch.argmax(ls, -1).to(torch.int32)
        for key in cs:
            assert torch.equal(cs[key], cv[key])
            assert cs[key].dtype == torch.bfloat16


@pytest.mark.parametrize("n,rate,seed,gen", [(8, 0.5, 0, 8), (16, 0.7, 3, 64),
                                             (5, 2.0, 1, 1)])
def test_poisson_trace_is_the_reference_trace(n, rate, seed, gen):
    a, g = serve.poisson_trace(n, rate, seed, gen)
    ja, jg = jserve.poisson_trace(n, rate, seed, gen)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(g, jg)
    assert a.dtype == ja.dtype and g.dtype == jg.dtype


TRACE = dict(reduced=True, slots=3, n_requests=6, prompt_len=8, gen_len=6,
             arrival_rate=0.7, seed=0, verbose=False)
SCHEDULE_METRICS = ("n_requests", "slots", "total_tokens", "makespan_steps",
                    "tok_per_step", "decode_steps", "mean_queue_delay_steps",
                    "max_queue_delay_steps")


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_trace_schedules_match_reference(mode):
    """The same trace gives the reference's request schedule exactly:
    arrival, start and finish of every request, makespan and queue
    delays. The port has no jit, so it reports no jit cache sizes."""
    fn, jfn = (serve.serve_continuous, jserve.serve_continuous) \
        if mode == "continuous" else (serve.serve_static,
                                      jserve.serve_static)
    got = fn(ARCH, device="cpu", **TRACE)
    want = jfn(ARCH, **TRACE)
    assert got.requests == want.requests
    for key in SCHEDULE_METRICS:
        assert got.metrics[key] == want.metrics[key], key
    assert got.metrics["mode"] == mode
    assert "jit_cache_sizes" not in got.metrics
    for r, toks in got.tokens.items():
        assert len(toks) == len(want.tokens[r])


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_continuous_tokens_equal_solo_and_static(weights, kernel):
    """Every request served through the slot ring gets exactly the greedy
    tokens it gets served alone and in the static batches: admission,
    eviction and neighbours do not leak across slots."""
    _, cfg, _, tp = weights
    kw = dict(TRACE, use_decode_kernel=kernel, params=tp, device="cpu")
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
                           use_decode_kernel=kernel, params=tp,
                           verbose=False, device="cpu")
        assert np.array_equal(solo.tokens[0], rc.tokens[r]), r
    assert rc.metrics["makespan_steps"] >= max(int(g) for g in gens)


def test_serve_and_replay_tokens_agree(weights):
    """Cache reuse and prompt replay give the same greedy tokens; reuse pays
    prefill with no cache set-up, replay the other way round."""
    _, _, _, tp = weights
    kw = dict(batch=2, prompt_len=8, gen_len=5, seed=0, params=tp,
              verbose=False, device="cpu")
    reuse = serve.serve(ARCH, **kw)
    replay = serve.serve_replay(ARCH, **kw)
    assert reuse.tokens.shape == (2, 5)
    assert np.array_equal(reuse.tokens, replay.tokens)
    assert reuse.timings["cache_setup_s"] == 0.0
    assert reuse.timings["prefill_s"] > 0.0
    assert replay.timings["prefill_s"] == 0.0
    assert replay.timings["cache_setup_s"] > 0.0


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "gumbel"])
def test_serve_replays_the_reference(weights, greedy, kernel):
    """``serve`` on the reference's weights and prompt, with its noise keys
    replayed through ``JaxStream(PRNGKey(seed + 2))``, gives the reference's
    tokens (Gumbel: the same draws, step for step)."""
    jcfg, cfg, jp, tp = weights
    seed = 0
    jb, tb = _prompt(cfg, seed=7)
    want = jserve.serve(ARCH, reduced=True, batch=B, prompt_len=S,
                        gen_len=6, greedy=greedy, seed=seed, prompt=jb,
                        verbose=False)
    got = serve.serve(ARCH, batch=B, prompt_len=S, gen_len=6, greedy=greedy,
                      seed=seed, prompt=tb, params=tp,
                      stream=JaxStream(jax.random.PRNGKey(seed + 2)),
                      use_decode_kernel=kernel, verbose=False, device="cpu")
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_with_flash_kernel_replays_the_reference(weights, kernel):
    """``serve(use_flash_kernel=True)`` (the prefill's attention on K4's
    route, its plain version on the CPU) gives the reference's greedy
    tokens: the reference's prefill and decode on the same weights and
    prompt."""
    jcfg, cfg, jp, tp = weights
    jb, tb = _prompt(cfg, s=24, seed=8)
    want = jserve.serve(ARCH, reduced=True, batch=B, prompt_len=24,
                        gen_len=6, seed=0, prompt=jb, verbose=False)
    got = serve.serve(ARCH, batch=B, prompt_len=24, gen_len=6, seed=0,
                      prompt=tb, params=tp, use_flash_kernel=True,
                      use_decode_kernel=kernel, verbose=False, device="cpu")
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_trace_drivers_pass_the_flash_kernel_through(weights, mode):
    """``serve_continuous``/``serve_static(use_flash_kernel=True)`` build
    the model with K4 and give the tokens of the default route; the CLI's
    ``--flash-kernel`` reaches ``serve``."""
    _, _, _, tp = weights
    fn = serve.serve_continuous if mode == "continuous" else \
        serve.serve_static
    kw = dict(slots=2, n_requests=4, prompt_len=6, gen_len=4, params=tp,
              verbose=False, device="cpu")
    on, off = fn(ARCH, use_flash_kernel=True, **kw), fn(ARCH, **kw)
    for r in range(4):
        np.testing.assert_array_equal(on.tokens[r], off.tokens[r])
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--flash-kernel",
                      "--batch", "2", "--prompt-len", "6", "--gen-len", "3"])
    assert res.tokens.shape == (2, 3)


def test_flash_kernel_flag_reaches_the_model(monkeypatch):
    seen = []
    real = serve.build

    def spy(cfg, call):
        seen.append(call.use_flash_kernel)
        return real(cfg, call)

    monkeypatch.setattr(serve, "build", spy)
    for flag in ([], ["--flash-kernel"]):
        serve.main(["--arch", ARCH, "--device", "cpu", "--mode", "static",
                    "--requests", "2", "--batch", "2", "--prompt-len", "4",
                    "--gen-len", "2", *flag])
    assert seen == [False, True]


def test_sampling_noise_chain():
    """Greedy noise is zeros and leaves the stream where it was; sampled
    noise draws from split(2)[1] and moves on to split(2)[0], as the
    reference's ``key, k = split(key)``."""
    st = rng.TorchStream(2)
    z, nxt = serve._noise(st, (2, 5), True, "cpu")
    assert nxt is st and not z.any()
    n, nxt = serve._noise(st, (2, 5), False, "cpu")
    assert torch.equal(n, st.split(2)[1].gumbel((2, 5), "cpu"))
    assert nxt.path == st.split(2)[0].path
    key = jax.random.PRNGKey(2)
    n, nxt = serve._noise(JaxStream(key), (3,), False, "cpu")
    k0, k1 = jax.random.split(key)
    np.testing.assert_array_equal(
        n.numpy(), np.asarray(jax.random.gumbel(k1, (3,), jnp.float32)))
    np.testing.assert_array_equal(np.asarray(nxt.key), np.asarray(k0))


def test_sample_batch_is_addressed_by_stream():
    cfg = get_config(ARCH, reduced=True)
    a = sample_batch(cfg, rng.TorchStream(1).fold(3), 2, 16, "cpu")
    b = sample_batch(cfg, rng.TorchStream(1).fold(3), 2, 16, "cpu")
    c = sample_batch(cfg, rng.TorchStream(1).fold(4), 2, 16, "cpu")
    for k in ("tokens", "labels"):
        assert a[k].dtype == torch.int32 and a[k].shape == (2, 16)
        assert torch.equal(a[k], b[k])
        assert 0 <= int(a[k].min()) and int(a[k].max()) < cfg.vocab_size
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], a["labels"])


def test_serve_entry_point_raises_without_cuda(monkeypatch):
    """``--device`` defaults to cuda: with no card the CLI raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--full", "--mode", "reuse",
                    "--decode-kernel"])


def test_serve_cli_runs_continuous_on_cpu():
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--mode",
                      "continuous", "--decode-kernel", "--requests", "4",
                      "--batch", "2", "--prompt-len", "6", "--gen-len",
                      "4"])
    assert all(rq["finish"] is not None for rq in res.requests.values())
    assert res.metrics["total_tokens"] == sum(len(t)
                                              for t in res.tokens.values())
