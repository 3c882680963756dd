"""The port's SSM serving path (reduced mamba2-1.3b): prefill into the
recurrent decode cache, batched and per-slot decode, and the serve drivers,
held against the reference with its weights carried across by
``repro_torch.bridge``.

Tolerances, and why:
* decode logits from the same cache (the reference's, carried across):
  fp32, to 1e-5 of the largest logit magnitude, as the dense serving tests:
  a decode step has no cumsum (one exp, mul and add per state element), so
  only the two frameworks' fp32 projection orders differ.
* the decode state after teacher-forced steps: to 1e-5 of its largest
  magnitude, for the same reason.
* token ids of two implementations (port against reference, prefill
  against prompt replay): the near-tie rule of
  ``repro_torch.kernels.ref.near_tie_check``, position by position while a
  row's earlier ids agree (after a near-tie flip the two continue from
  different tokens). Token streams of one implementation along two routes
  (slot ring, solo, static batches): exact.
* schedules and the Poisson trace: exact.

The reference's ``sample_batch`` folds the per-process salted
``hash(name)`` into its key, so prompts are handed to both sides as arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ssd_route import k7_route
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import ModelCallConfig, build
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
B, S, G = 2, 16, 5


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, reduced=True)
    jp = jbuild(jcfg, JCall(dtype=jnp.float32)).init(jax.random.PRNGKey(0))
    return jcfg, get_config(ARCH, reduced=True), jp, \
        params_from_jax(jax.device_get(jp), "cpu")


def _prompt(cfg, b=B, s=S, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks)})


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _ids_held(tm, tp, prompt, got, want):
    """Hold ids ``got`` (B, G) to ``want`` under the near-tie rule on the
    port's plain logits, teacher-forced on ``want``; a row is compared while
    its earlier ids agree. Returns the near-tie exceptions."""
    cfg = tm.cfg
    ties = 0
    live = np.ones(got.shape[0], bool)
    with torch.inference_mode():
        lg, cache = tm.prefill_cache(tp, prompt, S + G)
        for g in range(got.shape[1]):
            rows = np.flatnonzero(live)
            t, bad = ref.near_tie_check(
                lg[rows], torch.from_numpy(got[rows, g]),
                torch.from_numpy(want[rows, g]), cfg.vocab_size)
            assert bad == 0, g
            ties += t
            live &= got[:, g] == want[:, g]
            lg, cache = tm.decode(tp, cache, torch.from_numpy(want[:, g]),
                                  S + g)
    return ties


@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_teacher_forced_decode_from_reference_cache(weights, kernel,
                                                    pos_kind):
    """From the reference's prefill cache, carried across by
    ``cache_from_jax`` (nested ``mamba`` tree): each step both models get
    the reference's greedy token; logits and the final state agree at fp32
    tolerance, ``decode_sample`` ids (K6's plain version with ``kernel``)
    under the near-tie rule. Per-slot positions are accepted and unused."""
    jcfg, cfg, jp, tp = weights
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32,
                                    use_decode_kernel=kernel))
    jb, _ = _prompt(cfg)
    jl, jcache = jax.jit(jm.prefill_cache, static_argnums=2)(jp, jb, S + G)
    tcache = cache_from_jax(jax.device_get(jcache), "cpu")
    assert set(tcache) == {"mamba"} and tcache["mamba"]["h"].dtype == \
        torch.float32
    tcache2 = {"mamba": {k: v.clone() for k, v in tcache["mamba"].items()}}
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    jdecode = jax.jit(jm.decode)
    zeros = torch.zeros((B, jl.shape[-1]))
    ties = 0
    for g in range(G):
        p = S + g
        tpos = p if pos_kind == "scalar" else torch.full((B,), p,
                                                         dtype=torch.int32)
        ttok = torch.from_numpy(np.asarray(tok).copy())
        jl, jcache = jdecode(jp, jcache, tok, jnp.int32(p))
        with torch.inference_mode():
            tl, tcache = tm.decode(tp, tcache, ttok, tpos)
            ids, tcache2 = tm.decode_sample(tp, tcache2, ttok, tpos, zeros)
        _close(tl, jl, f"logits {g}")
        want = torch.from_numpy(
            np.asarray(jnp.argmax(jl[:, :cfg.vocab_size], -1)).copy())
        t, bad = ref.near_tie_check(tl, ids, want, cfg.vocab_size)
        assert bad == 0, g
        ties += t
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    assert ties <= 1
    for key, w in jcache["mamba"].items():
        _close(tcache["mamba"][key], w, key)


def test_reference_decodes_from_the_port_prefill_cache(weights):
    """The other way round: the port's prefill cache, carried into the
    reference, decodes to the port's own logits."""
    jcfg, cfg, jp, tp = weights
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    _, tb = _prompt(cfg)
    with torch.inference_mode():
        tl, tcache = tm.prefill_cache(tp, tb, S + G)
        jcache = {"mamba": {k: jnp.asarray(v.numpy().copy())
                            for k, v in tcache["mamba"].items()}}
        tok = torch.argmax(tl, -1).to(torch.int32)
        tl, tcache = tm.decode(tp, tcache, tok, S)
    jl, _ = jax.jit(jm.decode)(jp, jcache, jnp.asarray(tok.numpy()),
                               jnp.int32(S))
    _close(tl, jl, "logits")


def test_per_slot_decode_bitwise_equals_scalar(weights):
    """decode with pos = full((B,), p) is bitwise the scalar-pos decode
    (the ssm step does not read pos); the cache is updated in place, its
    leaves fp32."""
    _, cfg, _, tp = weights
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    _, tb = _prompt(cfg)
    with torch.inference_mode():
        _, cs = tm.prefill_cache(tp, tb, S + G)
        cv = {"mamba": {k: v.clone() for k, v in cs["mamba"].items()}}
        h = cs["mamba"]["h"]
        tok_s = tok_v = torch.zeros((B,), dtype=torch.int32)
        for g in range(G):
            ls, cs2 = tm.decode(tp, cs, tok_s, S + g)
            lv, cv2 = tm.decode(tp, cv, tok_v,
                                torch.full((B,), S + g, dtype=torch.int32))
            assert cs2 is cs and cv2 is cv and cs["mamba"]["h"] is h
            assert torch.equal(ls, lv), g
            tok_s = tok_v = torch.argmax(ls, -1).to(torch.int32)
        for key in cs["mamba"]:
            assert torch.equal(cs["mamba"][key], cv["mamba"][key])
            assert cs["mamba"][key].dtype == torch.float32


def test_init_cache_layout_matches_reference(weights):
    """``init_cache`` is the reference's tree: per-layer leaves stacked
    over L, slot-major, fp32, independent of the cache length."""
    jcfg, cfg, _, _ = weights
    jc = jbuild(jcfg, JCall(dtype=jnp.float32)).init_cache(3, 40)
    tc = build(cfg, ModelCallConfig(dtype=torch.float32)).init_cache(
        3, 40, "cpu")
    assert set(tc) == set(jc) == {"mamba"}
    for key, w in jc["mamba"].items():
        assert tuple(tc["mamba"][key].shape) == w.shape, key
        assert tc["mamba"][key].dtype == torch.float32
        assert not tc["mamba"][key].any()
    tc2 = T.init_decode_cache(cfg, 3, 4000, "cpu")
    assert tc2["mamba"]["h"].shape == tc["mamba"]["h"].shape


def test_insert_slot_walks_the_cache_tree():
    ring = {"mamba": {"h": torch.zeros(2, 3, 4), "conv_x": torch.zeros(
        2, 3, 5)}, "k": torch.zeros(2, 3, 1)}
    one = {"mamba": {"h": torch.ones(2, 1, 4), "conv_x": torch.full(
        (2, 1, 5), 2.0)}, "k": torch.full((2, 1, 1), 3.0)}
    serve.insert_slot(ring, one, 1)
    assert torch.equal(ring["mamba"]["h"][:, 1], torch.ones(2, 4))
    assert torch.equal(ring["mamba"]["conv_x"][:, 1], torch.full((2, 5), 2.0))
    assert torch.equal(ring["k"][:, 1], torch.full((2, 1), 3.0))
    for leaf in (ring["mamba"]["h"], ring["mamba"]["conv_x"], ring["k"]):
        assert not leaf[:, 0].any() and not leaf[:, 2].any()


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_serve_replays_the_reference(weights, monkeypatch, kernel):
    """``serve`` on the reference's weights and prompt gives the
    reference's greedy ids under the near-tie rule; ``kernel`` runs the
    prefill's SSD on the card's route (forced) and the sampling on K6's
    (their plain versions on the CPU)."""
    jcfg, cfg, jp, tp = weights
    calls = k7_route(monkeypatch, force=kernel)
    jb, tb = _prompt(cfg, seed=7)
    want = jserve.serve(ARCH, reduced=True, batch=B, prompt_len=S,
                        gen_len=G, seed=0, prompt=jb, verbose=False)
    got = serve.serve(ARCH, batch=B, prompt_len=S, gen_len=G, seed=0,
                      prompt=tb, params=tp, use_decode_kernel=kernel,
                      verbose=False, device="cpu")
    assert len(calls) == cfg.n_layers * kernel
    assert got.tokens.shape == (B, G)
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    assert _ids_held(tm, tp, tb, got.tokens, np.asarray(want.tokens)) <= 1


def test_serve_and_replay_tokens_agree(weights):
    """Cache reuse (chunked prefill) and prompt replay (token by token)
    give the same greedy ids under the near-tie rule; reuse pays prefill
    with no cache set-up, replay the other way round."""
    _, cfg, _, tp = weights
    kw = dict(batch=B, prompt_len=S, gen_len=G, seed=0, params=tp,
              verbose=False, device="cpu")
    reuse = serve.serve(ARCH, **kw)
    replay = serve.serve_replay(ARCH, **kw)
    assert reuse.timings["cache_setup_s"] == 0.0
    assert replay.timings["prefill_s"] == 0.0
    prompt = serve.sample_batch(cfg, serve.rng.TorchStream(1), B, S, "cpu")
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    assert _ids_held(tm, tp, prompt, reuse.tokens, replay.tokens) <= 1


TRACE = dict(reduced=True, slots=3, n_requests=6, prompt_len=8, gen_len=6,
             arrival_rate=0.7, seed=0, verbose=False)
SCHEDULE_METRICS = ("n_requests", "slots", "total_tokens", "makespan_steps",
                    "tok_per_step", "decode_steps", "mean_queue_delay_steps",
                    "max_queue_delay_steps")


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_trace_schedules_match_reference(mode):
    fn, jfn = (serve.serve_continuous, jserve.serve_continuous) \
        if mode == "continuous" else (serve.serve_static,
                                      jserve.serve_static)
    got = fn(ARCH, device="cpu", **TRACE)
    want = jfn(ARCH, **TRACE)
    assert got.requests == want.requests
    for key in SCHEDULE_METRICS:
        assert got.metrics[key] == want.metrics[key], key


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_continuous_tokens_equal_solo_and_static(weights, monkeypatch,
                                                  kernel):
    """Every request served through the slot ring (its B=1 prefill cache
    tree inserted into a slot) gets exactly the greedy tokens it gets
    served alone and in the static batches: admission, eviction and
    neighbours do not leak across slots. ``kernel`` forces the card's SSD
    route and samples on K6's."""
    _, cfg, _, tp = weights
    k7_route(monkeypatch, force=kernel)
    kw = dict(TRACE, use_decode_kernel=kernel, params=tp, device="cpu")
    rc = serve.serve_continuous(ARCH, **kw)
    rs = serve.serve_static(ARCH, **kw)
    _, gens = serve.poisson_trace(TRACE["n_requests"], TRACE["arrival_rate"],
                                  TRACE["seed"], TRACE["gen_len"])
    for r in range(TRACE["n_requests"]):
        assert np.array_equal(rc.tokens[r], rs.tokens[r]), r
        solo = serve.serve(ARCH, batch=1, prompt_len=TRACE["prompt_len"],
                           gen_len=int(gens[r]),
                           prompt=serve.request_prompt(
                               cfg, TRACE["seed"], r, TRACE["prompt_len"],
                               "cpu"),
                           use_decode_kernel=kernel, params=tp,
                           verbose=False, device="cpu")
        assert np.array_equal(solo.tokens[0], rc.tokens[r]), r


def test_ssd_kernel_flag_reaches_the_model(monkeypatch):
    """Every serve mode prefills through one call of the SSD route's
    composition a layer where the route is forced (as on the card), and
    through none on the CPU's own route; replay has no prefill."""
    cfg = get_config(ARCH, reduced=True)
    prefills = []
    real = serve.build

    def spy(cfg, call):
        model = real(cfg, call)
        fn = model.prefill_cache

        def prefill_cache(*a, **kw):
            prefills.append(1)
            return fn(*a, **kw)
        model.prefill_cache = prefill_cache
        return model

    monkeypatch.setattr(serve, "build", spy)
    for mode in ("reuse", "replay", "continuous", "static"):
        for force in (False, True):
            prefills.clear()
            calls = k7_route(monkeypatch, force=force)
            serve.main(["--arch", ARCH, "--device", "cpu", "--mode", mode,
                        "--requests", "2", "--batch", "2", "--prompt-len",
                        "4", "--gen-len", "4"])
            assert bool(prefills) == (mode != "replay"), mode
            assert len(calls) == cfg.n_layers * len(prefills) * force, mode


def test_serve_cli_runs_continuous_with_kernels_on_cpu(monkeypatch):
    k7_route(monkeypatch)
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--mode",
                      "continuous", "--decode-kernel", "--requests", "4",
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert all(rq["finish"] is not None for rq in res.requests.values())
    assert res.metrics["total_tokens"] == sum(len(t)
                                              for t in res.tokens.values())
    cfg = get_config(ARCH, reduced=True)
    assert all(int(t.max()) < cfg.vocab_size for t in res.tokens.values())
