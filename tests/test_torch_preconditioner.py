"""The port's preconditioner family held against the reference, on the cases
of tests/test_preconditioner.py (Lemma 1 / Assumption 4).

Each case feeds the same numpy stats to ``repro.core.preconditioner`` and to
``repro_torch.core.preconditioner``. D updates and D̂ agree to 4 fp32 ulp of
the operand scale (XLA may contract the EMA's mul+add into an FMA; the debias
β_t goes through two frameworks' ``pow``); the Lemma 1 bounds are asserted on
the port's own values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rng_replay import JaxStream
from repro.core import preconditioner as JPC
from repro.kernels import ops as jops
from repro_torch.core import preconditioner as PC
from repro_torch.kernels import ops
from repro_torch.utils import rng

torch.set_num_threads(1)

ULP_TOL = 4 * np.finfo(np.float32).eps


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ULP_TOL * max(np.abs(want).max(), 1e-30))


def _pair(vals):
    """The same tree for both packages: ({"a": jnp}, {"a": torch})."""
    a = np.asarray(vals, np.float32)
    return {"a": jnp.asarray(a)}, {"a": torch.from_numpy(a.copy())}


@pytest.mark.parametrize("kind", ["adam", "rmsprop", "adagrad", "oasis"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lemma1_bounds_match_reference(kind, seed):
    """Item 1 of Lemma 1: with |H^t| ≤ Γ elementwise, D̂^t stays in [α, Γ']
    (Γ' = max(Γ, D̂⁰=1), + α for AdaGrad's accumulation bound below) — and
    every step's D and D̂ match the reference."""
    rng = np.random.default_rng(seed)
    alpha, gamma_cap, steps = float(rng.uniform(1e-4, 1e-1)), \
        float(rng.uniform(0.5, 20.0)), 8
    jcfg = JPC.PrecondConfig(kind=kind, alpha=alpha)
    cfg = PC.PrecondConfig(kind=kind, alpha=alpha)
    jz, tz = _pair(np.zeros(16))
    jst, st = JPC.init_state(jcfg, jz), PC.init_state(cfg, tz)
    cap = max(gamma_cap, 1.0)
    for _ in range(steps):
        h = rng.uniform(-gamma_cap, gamma_cap, size=16).astype(np.float32)
        stat = np.abs(h) if cfg.rule == "linear" else h ** 2
        js, ts = _pair(stat)
        jst, st = JPC.update(jcfg, jst, js), PC.update(cfg, st, ts)
        _close(st["d"]["a"].numpy(), jst["d"]["a"])
        assert int(st["t"]) == int(jst["t"])
        dh = PC.dhat(cfg, st)["a"].numpy()
        _close(dh, JPC.dhat(jcfg, jst)["a"])
        assert np.all(dh >= alpha - 1e-7)
        if kind != "adagrad":
            assert np.all(dh <= cap + alpha + 1e-5)


@pytest.mark.parametrize("kind", ["rmsprop", "oasis"])
@pytest.mark.parametrize("beta", [0.5, 0.9, 0.999])
def test_lemma1_drift_ratio(kind, beta):
    """Items 2/3: D̂^{t+1} ⪯ (1 + (1-β)C) D̂^t with C = Γ²/2α² (rule 2) or
    2Γ/α (rule 3)."""
    alpha, Gamma = 0.1, 2.0
    cfg = PC.PrecondConfig(kind=kind, alpha=alpha, beta2=beta)
    rng = np.random.default_rng(0)
    st = PC.init_state(cfg, {"a": torch.zeros(32)})
    C = Gamma**2 / (2 * alpha**2) if cfg.rule == "squared" \
        else 2 * Gamma / alpha
    for _ in range(8):
        prev = PC.dhat(cfg, st)["a"].numpy()
        h = rng.uniform(-Gamma, Gamma, size=32).astype(np.float32)
        stat = h ** 2 if cfg.rule == "squared" else h
        st = PC.update(cfg, st, {"a": torch.from_numpy(stat)})
        cur = PC.dhat(cfg, st)["a"].numpy()
        assert np.all(cur <= prev * (1.0 + (1.0 - beta) * C) + 1e-6)


def test_identity_is_noop():
    cfg = PC.PrecondConfig(kind="identity")
    st = PC.init_state(cfg, {"a": torch.ones(4)})
    g = {"a": torch.tensor([1.0, -2.0, 3.0, -4.0])}
    assert PC.precondition(cfg, st, g)["a"] is g["a"]
    assert int(PC.update(cfg, st, g)["t"]) == 1


@pytest.mark.parametrize("beta", [0.9, 0.99, 0.999])
def test_adam_debias_first_betas_match_reference(beta):
    """β_t = (β − β^{t+1}) / (1 − β^{t+1}): β₀ = 0, β₁ = β/(1+β), → β; the
    port's values equal the reference's to 4 ulp at t = 0..9 and 10 000."""
    cfg = PC.PrecondConfig(kind="adam", beta2=beta)
    jcfg = JPC.PrecondConfig(kind="adam", beta2=beta)
    t = np.array([0, 1, 2, 3, 5, 9, 10_000], np.int32)
    got = PC.beta_t(cfg, torch.from_numpy(t)).numpy()
    _close(got, JPC.beta_t(jcfg, jnp.asarray(t)))
    np.testing.assert_allclose(got[0], 0.0, atol=1e-7)
    np.testing.assert_allclose(got[1], beta / (1.0 + beta), rtol=1e-4)
    assert abs(got[-1] - beta) < 1e-4
    # the debiased first update takes the whole new stat: D² = H²
    st = PC.update(cfg, PC.init_state(cfg, {"a": torch.zeros(4)}),
                   {"a": torch.full((4,), 9.0)})
    np.testing.assert_allclose(PC.dhat(cfg, st)["a"].numpy(), 3.0, rtol=1e-6)


def test_const_schedule_beta_is_fp32_of_beta2():
    cfg = PC.PrecondConfig(kind="rmsprop", beta2=0.999)
    b = PC.beta_t(cfg, torch.zeros((3,), dtype=torch.int32))
    assert b.dtype == torch.float32 and b.shape == (3,)
    assert float(b[0]) == float(np.float32(0.999))


def test_adagrad_accumulates():
    cfg = PC.PrecondConfig(kind="adagrad", alpha=1e-3)
    assert PC.beta_t(cfg, torch.zeros((), dtype=torch.int32)) is None
    st = PC.init_state(cfg, {"a": torch.zeros(3)})
    for _ in range(5):
        st = PC.update(cfg, st, {"a": torch.ones(3)})
    # D² = 1 (init) + 5 -> D̂ = sqrt(6)
    np.testing.assert_allclose(PC.dhat(cfg, st)["a"].numpy(), np.sqrt(6.0),
                               rtol=1e-6)


@pytest.mark.parametrize("kind,clip", [("rmsprop", "max"), ("adam", "add"),
                                       ("oasis", "max"), ("oasis", "add")])
def test_bounds_and_precondition_match_reference(kind, clip):
    jcfg = JPC.PrecondConfig(kind=kind, alpha=0.01, clip=clip)
    cfg = PC.PrecondConfig(kind=kind, alpha=0.01, clip=clip)
    jz, tz = _pair(np.zeros(8))
    raw = np.linspace(-4, 4, 8).astype(np.float32)
    js, ts = _pair(raw if kind == "oasis" else raw ** 2)
    jst = JPC.update(jcfg, JPC.init_state(jcfg, jz), js)
    st = PC.update(cfg, PC.init_state(cfg, tz), ts)
    for got, want in zip(PC.bounds(cfg, st), JPC.bounds(jcfg, jst)):
        _close(float(got), float(want))
    lo, hi = PC.bounds(cfg, st)
    assert float(lo) >= 0.01 - 1e-8
    jg, tg = _pair(np.arange(1.0, 9.0))
    _close(PC.precondition(cfg, st, tg)["a"].numpy(),
           JPC.precondition(jcfg, jst, jg)["a"])


def _quadratic(d=12, seed=1):
    """The quadratic of tests/test_preconditioner.py's Hutchinson case."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    Q = (A @ A.T / d + np.eye(d)).astype(np.float32)
    x0 = rng.normal(size=d).astype(np.float32)
    return Q, x0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hutchinson_matches_reference_on_quadratic(seed):
    """Same Rademacher probes (the reference's keys, replayed): v ⊙ Qv to
    fp32 rounding of the largest entry (forward-over-reverse there,
    reverse-over-reverse here)."""
    Q, x0 = _quadratic()
    jQ, tQ = jnp.asarray(Q), torch.from_numpy(Q)
    jloss = lambda p, b: 0.5 * p["x"] @ jQ @ p["x"]
    tloss = lambda p, b: 0.5 * p["x"] @ tQ @ p["x"]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JPC.hutchinson_diag(jloss, {"x": jnp.asarray(x0)},
                                          None, key)["x"])
    got = PC.hutchinson_diag(tloss, {"x": torch.from_numpy(x0)}, None,
                             JaxStream(key))["x"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_hutchinson_unbiased_on_quadratic():
    """E[v ⊙ Qv] = diag(Q) for Rademacher v, on the port's own stream."""
    Q, x0 = _quadratic()
    tQ = torch.from_numpy(Q)
    loss = lambda p, b: 0.5 * p["x"] @ tQ @ p["x"]
    root = rng.TorchStream(0)
    ests = [PC.hutchinson_diag(loss, {"x": torch.from_numpy(x0)}, None,
                               root.fold(i))["x"].numpy()
            for i in range(200)]
    np.testing.assert_allclose(np.mean(ests, axis=0), np.diag(Q), rtol=0.25,
                               atol=0.05)


def test_hutchinson_matches_reference_on_reduced_qwen2():
    """One probe per parameter leaf from split(n_leaves), on reduced
    qwen2-0.5b with the reference's weights and batch. Tolerance 1e-4 of each
    leaf's largest magnitude: the HVP runs through the whole model in two
    frameworks and two differentiation orders. The port's checkpointed
    layers give the same stat as unchecked ones."""
    from repro.configs import get_config as jget_config
    from repro.data import LMRoundLoader as JLoader
    from repro.data import TokenStream as JStream
    from repro.models import ModelCallConfig as JCall
    from repro.models import build as jbuild
    from repro.utils.tree import tree_paths as jtree_paths
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.models import ModelCallConfig, build
    from repro_torch.utils.tree import tree_paths

    jm = jbuild(jget_config("qwen2-0.5b", reduced=True),
                JCall(dtype=jnp.float32, remat=False))
    jp = jm.init(jax.random.PRNGKey(0))
    nb = JLoader(JStream(jm.cfg.vocab_size, seed=0), 1, 2).round_batch(0, 1,
                                                                      8)
    micro = {k: v[0, 0] for k, v in nb.items()}
    key = jax.random.PRNGKey(3)
    want = dict(jtree_paths(jax.device_get(JPC.hutchinson_diag(
        jm.loss, jp, jax.tree.map(jnp.asarray, micro), key))))
    tp = params_from_jax(jax.device_get(jp), "cpu")
    tmicro = {k: torch.from_numpy(v).long() for k, v in micro.items()}
    cfg = get_config("qwen2-0.5b", reduced=True)
    outs = [dict(tree_paths(PC.hutchinson_diag(
        build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat)).loss,
        tp, tmicro, JaxStream(key)))) for remat in (False, True)]
    assert outs[0].keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(outs[0][k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
        assert torch.equal(outs[0][k], outs[1][k]), k


# --------------------------------------------------------------------------- #
# Lemma 1 bounds THROUGH fused updates: the port's wrapper (plain version on
# the CPU) against the reference's Pallas kernel in interpret mode
# --------------------------------------------------------------------------- #


def _fused_d_evolution(fused, conv, cfg, stats, d0):
    """Evolve d with a fused step (stats (T, M, n); external for rule 3,
    in-step g² for rule 2) and return the final d buffer."""
    M, n = stats.shape[1:]
    p, m = conv(np.zeros((M, n), np.float32)), conv(np.zeros((M, n),
                                                             np.float32))
    d = conv(np.asarray(d0, np.float32))
    for step, h in enumerate(stats):
        t = conv(np.full((M,), step, np.int32))
        if cfg.rule == "linear":
            g, hs = conv(np.zeros((M, n), np.float32)), conv(h)
        else:
            g, hs = conv(np.sqrt(h).astype(np.float32)), None
        p, m, d = fused(p, m, g, d, hs, t, None, gamma=0.0, beta1=0.0,
                        alpha=cfg.alpha, beta2=cfg.beta2, kind=cfg.kind,
                        clip=cfg.clip, schedule=cfg.schedule, update_d=True)
    return np.asarray(d)


@pytest.mark.parametrize("kind,clip", [("adam", "max"), ("adam", "add"),
                                       ("rmsprop", "max"), ("rmsprop", "add"),
                                       ("oasis", "max"), ("oasis", "add")])
def test_lemma1_bounds_through_fused_updates(kind, clip):
    """|H| ≤ Γ keeps D̂ in [α, Γ'] through fused updates, including OASIS
    driven by negative stats and the additive clip; d matches the
    reference's fused kernel."""
    alpha, Gamma, n, T = 0.05, 3.0, 48, 8
    cfg = PC.PrecondConfig(kind=kind, alpha=alpha, clip=clip, beta2=0.5)
    rng = np.random.default_rng(1)
    raw = rng.uniform(-Gamma, Gamma, size=(T, 1, n)).astype(np.float32)
    stats = raw if cfg.rule == "linear" else raw ** 2
    d0 = np.ones((1, n), np.float32)
    # copies: the port's step updates its buffers in place
    d = _fused_d_evolution(ops.fused_local_step,
                           lambda a: torch.from_numpy(np.array(a)), cfg,
                           stats, d0)
    jd = _fused_d_evolution(jops.fused_local_step, jnp.asarray, cfg, stats,
                            d0)
    _close(d, jd)
    if cfg.rule == "linear":
        assert float(d.min()) < 0.0   # signed D really occurs
    lo, hi = PC.bounds(cfg, {"d": {"a": torch.from_numpy(d[0])}})
    assert float(lo) >= alpha - 1e-7
    assert float(hi) <= Gamma + (alpha if clip == "add" else 0.0) + 1e-4
