"""The port's paper-experiment slice held against the reference on the CPU:
the data layer (``ClassificationData``, ``QuadraticProblem``, the loaders,
the partitioners), ``core/theory.py``, ``core/schedules.py``, the Fig. 1
MLP, and ``launch/paper.py``'s runners against ``benchmarks/run.py``'s
(fig1, the quadratic runner, sec52, the summaries), plus the port's presets
against the frozen pre-refactor oracles on the quadratic.

Tolerances, and why:
* data, partitions, scores, theory: exact (the same numpy code on the same
  seeds; arrays compared byte for byte).
* schedules: 1e-6 relative (fp32 sqrt and cos of two libraries).
* the MLP's loss and gradients: 1e-5 of the largest magnitude (two fp32
  matmul orders).
* Fig. 1 rounds (M = 4, H = 2, 3 rounds, 800 examples; the reference's init
  carried across, its round keys replayed through ``JaxStream``): per-round
  loss to 1e-5 relative, test accuracy to 2 examples of the 100 held out
  (an argmax may flip where two logits are within rounding).
* quadratic distances, sec52 step norms: 1e-5 relative.
* the oracles of the pre-refactor round (``tests/_reference_savic.py``,
  ``_reference_fedopt.py``, ``_reference_engine.py``), with their
  ``use_fused_kernel`` off and on (on reaches the reference's K2): every
  state leaf within ``ORACLE_ULPS`` = 256 fp32 ulps of its largest
  magnitude after each round. K2 computes p − (γ·m)/D̂ where the port's tree
  and fused loops compute p − γ·(m/D̂), XLA contracts β₁m + g into one FMA,
  and the gradients' d = 24-term sums run in two orders: each is an ulp of
  the step's operands. Global D̂ = max(α, |ḡ|) amplifies them where the
  client-averaged gradient ḡ cancels (a few ulps of the clients' gradients
  are then a larger share of |ḡ|, until α holds D̂), and heavy-ball momentum
  carries them over the 30 steps (6 rounds × H = 5): SAVIC with global Adam
  and β₁ = 0.9 reaches 127 ulps of the momentum's scale on the tree loop
  (42 of the params'), every other case stays under 70.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _reference_engine as ref_engine
import _reference_fedopt as ref_fedopt
import _reference_savic as ref_savic
from _torch_rng_replay import JaxStream
from benchmarks import run as jrun
from benchmarks.matrix import Point
from repro.core import PrecondConfig as JPrecondConfig
from repro.core import schedules as jsched
from repro.core import theory as jtheory
from repro.data import federated as jfed
from repro.data import loader as jloader
from repro.data import synthetic as jsyn
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.core import (PrecondConfig, SavicConfig, engine, fedopt,
                              savic, schedules, theory)
from repro_torch.data import federated, loader, synthetic
from repro_torch.launch import paper
from repro_torch.models import mlp

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
ORACLE_ULPS = 256


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# --------------------------------------------------------------------------- #
# the data layer: byte-identical
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_classification_data_is_the_reference(seed):
    got = synthetic.ClassificationData.make(n=600, seed=seed)
    want = jsyn.ClassificationData.make(n=600, seed=seed)
    _same(got.x, want.x)
    _same(got.y, want.y)
    assert got.n_classes == want.n_classes == 10


@pytest.mark.parametrize("kw", [dict(d=24, M=8, mu=0.5, L=4.0, sigma=0.6,
                                     seed=1),
                                dict(d=24, M=8, mu=0.5, L=4.0, sigma=0.2,
                                     heterogeneity=6.0, seed=2),
                                dict(d=32, M=3, seed=5)])
def test_quadratic_problem_is_the_reference(kw):
    got, want = (m.QuadraticProblem.make(**kw) for m in (synthetic, jsyn))
    _same(got.Q, want.Q)
    _same(got.b, want.b)
    _same(got.x_star(), want.x_star())
    assert got.sigma_dif2() == want.sigma_dif2()
    assert (got.sigma, got.mu, got.L) == (want.sigma, want.mu, want.L)


@pytest.mark.parametrize("seed", [0, 3])
def test_loaders_give_the_reference_batches(seed):
    data = jsyn.ClassificationData.make(n=700, seed=seed)
    parts = jfed.main_class_partition(data.y, 5, 0.5, seed=seed)
    fl = loader.FederatedLoader(data.x, data.y, parts, 16, seed=seed)
    jfl = jloader.FederatedLoader(data.x, data.y, parts, 16, seed=seed)
    prob = jsyn.QuadraticProblem.make(d=12, M=4, seed=seed)
    ql = loader.QuadraticLoader(prob, seed=seed)
    jql = jloader.QuadraticLoader(prob, seed=seed)
    for _ in range(3):
        for got, want in ((fl.round_batch(3), jfl.round_batch(3)),
                          (ql.round_batch(4), jql.round_batch(4))):
            assert sorted(got) == sorted(want)
            for k in want:
                _same(got[k], want[k])
    assert fl.n_clients == 5


def test_federated_loader_refuses_labeled_masks():
    """The loader no longer refuses a labeled mask (the objectives are
    ported): it attaches the reference's "labeled" leaf, byte for byte."""
    data = jsyn.ClassificationData.make(n=100)
    lab = jfed.labeled_mask(data.y, 0.3, seed=1)
    got = loader.FederatedLoader(data.x, data.y, [np.arange(100)], 4,
                                 labeled=lab).round_batch(2)
    want = jloader.FederatedLoader(data.x, data.y, [np.arange(100)], 4,
                                   labeled=lab).round_batch(2)
    assert got.keys() == want.keys() == {"x", "y", "labeled"}
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.filterwarnings("ignore:main_class_partition")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partitioners_and_scores_are_the_reference(seed):
    labels = jsyn.ClassificationData.make(n=1000, seed=seed).y
    cases = [("main_class_partition", (labels, 10, f), dict(seed=seed))
             for f in (0.3, 0.5, 0.7)]
    cases += [("dirichlet_partition", (labels, 6, a), dict(seed=seed))
              for a in (0.1, 1.0)]
    cases += [("iid_partition", (1000, 7), dict(seed=seed))]
    for name, args, kw in cases:
        got = getattr(federated, name)(*args, **kw)
        want = getattr(jfed, name)(*args, **kw)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _same(g, w)
        if name != "iid_partition":
            assert federated.heterogeneity_score(labels, got) \
                == jfed.heterogeneity_score(labels, want)
            _same(federated.realized_main_fraction(labels, got),
                  jfed.realized_main_fraction(labels, want))
    raw = np.random.default_rng(seed).dirichlet([0.5] * 10) * 97
    _same(federated._largest_remainder(raw, 97),
          jfed._largest_remainder(raw, 97))


def test_main_class_partition_warns_when_a_pool_runs_dry():
    """A main class with fewer examples than its client needs: both warn
    and top up the same way."""
    labels = jsyn.ClassificationData.make(n=1000, seed=2).y
    with pytest.warns(UserWarning, match="ran dry"):
        got = federated.main_class_partition(labels, 10, 0.5, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jfed.main_class_partition(labels, 10, 0.5, seed=2)
    for g, w in zip(got, want):
        _same(g, w)


# --------------------------------------------------------------------------- #
# theory and schedules
# --------------------------------------------------------------------------- #


def test_theory_is_the_reference():
    kw = dict(mu=0.5, L=4.0, sigma2=0.36, alpha=0.1, Gamma=2.0, M=8, H=4)
    spec, jspec = theory.ProblemSpec(**kw), jtheory.ProblemSpec(**kw)
    assert (spec.kappa, spec.kappa_hat) == (jspec.kappa, jspec.kappa_hat)
    for name in ("thm1_rate", "thm1_noise_ball", "local_sgd_noise_ball"):
        for gamma in (0.01, 0.05):
            assert getattr(theory, name)(spec, gamma) \
                == getattr(jtheory, name)(jspec, gamma), name
    for name in ("thm1_gamma_max", "thm2_gamma_max"):
        assert getattr(theory, name)(spec) == getattr(jtheory, name)(jspec)
    assert theory.thm2_bound(spec, 0.04, 80, 3.0, 1.5) \
        == jtheory.thm2_bound(jspec, 0.04, 80, 3.0, 1.5)
    assert theory.cor2_params(spec, 2.0) == jtheory.cor2_params(jspec, 2.0)


def test_schedules_are_the_reference():
    ts = [0, 1, 3, 7, 50, 200]
    pairs = [(schedules.inv_sqrt(0.1), jsched.inv_sqrt(0.1)),
             (schedules.inv_sqrt(0.1, warmup=10),
              jsched.inv_sqrt(0.1, warmup=10)),
             (schedules.cosine(0.1, 100), jsched.cosine(0.1, 100)),
             (schedules.cosine(0.1, 100, floor=0.01),
              jsched.cosine(0.1, 100, floor=0.01))]
    for f, jf in pairs:
        got = f(torch.tensor(ts))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jf(jnp.array(ts))),
                                   rtol=1e-6)
        for t in ts:
            np.testing.assert_allclose(float(f(t)), float(jf(t)), rtol=1e-6)
    assert schedules.constant(0.3)(9) == jsched.constant(0.3)(9)
    for rule in ("squared", "linear"):
        assert schedules.corollary1_beta(rule, 0.05, 0.5, 0.1, 2.0) \
            == jsched.corollary1_beta(rule, 0.05, 0.5, 0.1, 2.0)


# --------------------------------------------------------------------------- #
# the Fig. 1 MLP
# --------------------------------------------------------------------------- #


def test_mlp_loss_grads_and_accuracy_match_the_reference():
    jinit, jloss, jacc = jrun._mlp(mlp.N_IN, mlp.N_CLASSES)
    jp = jax.device_get(jinit(jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {"w1": (192, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)}
    assert sum(v.numel() for v in tp.values()) == 25_994
    data = jsyn.ClassificationData.make(n=64, seed=3)
    batch = {"x": data.x, "y": data.y}
    jl, jg = jax.value_and_grad(jloss)(jp, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl = mlp.loss(leaves, {"x": torch.from_numpy(data.x),
                           "y": torch.from_numpy(data.y).long()})
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jg:
        w = np.asarray(jg[k])
        np.testing.assert_allclose(leaves[k].grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    assert mlp.acc(tp, torch.from_numpy(data.x),
                   torch.from_numpy(data.y).long()) \
        == jacc(jp, jnp.asarray(data.x), jnp.asarray(data.y))
    # the port's own init: the reference's shapes and scales
    own = mlp.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in tp.items()}
    assert float(own["b1"].abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# launch/paper.py against benchmarks/run.py
# --------------------------------------------------------------------------- #

FIG1_SMALL = dict(n=800, ntest=100, clients=4, h_local=2, rounds=3)


@pytest.fixture(scope="module")
def fig1_env():
    seed, s = 0, FIG1_SMALL
    data = jsyn.ClassificationData.make(n=s["n"], n_classes=10, seed=seed)
    parts = jfed.main_class_partition(data.y[:-s["ntest"]], s["clients"],
                                      0.5, seed=seed)
    return data, parts


def _jax_fig1_rows(method, data, parts):
    s = FIG1_SMALL
    ctx = {"fig1_env": dict(data=data, ntest=s["ntest"], parts={0.5: parts},
                            xte=jnp.asarray(data.x[-s["ntest"]:]),
                            yte=jnp.asarray(data.y[-s["ntest"]:]))}
    point = Point(coords={"main_frac": 0.5, "method": method},
                  fixed=dict(clients=s["clients"], rounds=s["rounds"],
                             h_local=s["h_local"]), seed=0)
    return jrun._run_fig1(point, ctx)


def _round_keys(seed, rounds):
    """The reference runners' round keys: ``key, k = split(key)`` from
    ``PRNGKey(seed + 1)``."""
    key, ks = jax.random.PRNGKey(seed + 1), []
    for _ in range(rounds):
        key, k = jax.random.split(key)
        ks.append(k)
    return ks


@pytest.mark.parametrize("method", list(paper.FIG1_METHODS))
def test_fig1_rounds_match_the_reference(fig1_env, method):
    """Each Fig. 1 method, on the tree and on the fused client loop, from the
    reference's init with its round keys replayed."""
    data, parts = fig1_env
    s = FIG1_SMALL
    want = _jax_fig1_rows(method, data, parts)
    jinit, _, _ = jrun._mlp(192, 10)
    init = params_from_jax(jax.device_get(jinit(jax.random.PRNGKey(0))),
                           "cpu")
    ks = _round_keys(0, s["rounds"])
    for fused in (False, True):
        got = paper.fig1_run(0.5, method, device="cpu", data=data,
                             ntest=s["ntest"], parts=parts,
                             rounds=s["rounds"], h_local=s["h_local"],
                             use_fused_kernel=fused,
                             init_params=lambda g: {k: v.clone() for k, v
                                                    in init.items()},
                             streams=lambda r: JaxStream(ks[r]))
        assert len(got) == len(want) == s["rounds"]
        for g, w in zip(got, want):
            assert g["coords"] == {k: w["coords"][k] for k in g["coords"]}
            np.testing.assert_allclose(g["metrics"]["loss"],
                                       w["metrics"]["loss"], rtol=1e-5)
            assert abs(g["metrics"]["test_acc"] - w["metrics"]["test_acc"]) \
                <= 2 / s["ntest"] + 1e-6


@pytest.mark.parametrize("kind,H,rounds,fused", [("identity", 4, 8, False),
                                                 ("identity", 4, 8, True),
                                                 ("adam", 2, 6, False),
                                                 ("adam", 2, 6, True)])
def test_quad_runner_matches_the_reference(kind, H, rounds, fused):
    prob = jsyn.QuadraticProblem.make(d=24, M=8, mu=0.5, L=4.0, sigma=0.6,
                                      seed=1)
    alpha = 1e-8 if kind == "identity" else 1e-2
    want = jrun._quad_runner(prob, 0.05, H, rounds, kind=kind, alpha=alpha,
                             seed=1)
    ks = _round_keys(1, rounds)
    got = paper.quad_run(prob, 0.05, H, rounds, device="cpu", kind=kind,
                         alpha=alpha, seed=1, use_fused_kernel=fused,
                         streams=lambda r: JaxStream(ks[r]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("v_init,tau", paper.SEC52_POINTS)
def test_sec52_step_norms_match_the_reference(v_init, tau):
    point = Point(coords={"v_init": v_init, "tau": tau},
                  fixed=dict(paper.SEC52, method="fedadagrad"), seed=0)
    want = jrun._run_sec52(point, {})[0]
    for fused in (False, True):
        got = paper.sec52_row(v_init, tau, device="cpu",
                              use_fused_kernel=fused)
        assert got["coords"] == want["coords"]
        np.testing.assert_allclose(got["metrics"]["mean_step_norm"],
                                   want["metrics"]["mean_step_norm"],
                                   rtol=1e-5)


def test_summaries_are_the_reference_summaries(monkeypatch, fig1_env):
    """``paper.summary`` equals ``benchmarks/run.py``'s ``_sum_*`` on the
    port's own rows. The quadratic runs are cut to 12 rounds here: the
    summaries only read the rows."""
    data, parts = fig1_env
    rows = []
    for frac in (0.3, 0.5):
        for method in ("SGD", "Adam global"):
            rows += paper.fig1_run(frac, method, device="cpu", data=data,
                                   ntest=100, parts=parts, rounds=11,
                                   h_local=1)
    real = paper.quad_run
    monkeypatch.setattr(paper, "quad_run", lambda prob, g, H, rounds, **kw:
                        real(prob, g, H, min(rounds, 12), **kw))
    by_exp = {"fig1": rows,
              "thm1": [r for e in paper.THM1_EXPERIMENTS
                       for r in paper.thm1_rows(e, device="cpu")],
              "thm2": [r for e in paper.THM2_EXPERIMENTS
                       for r in paper.thm2_rows(e, device="cpu")],
              "sec52": [paper.sec52_row(v, t, device="cpu")
                        for v, t in paper.SEC52_POINTS]}
    jsum = {"fig1": jrun._sum_fig1, "thm1": jrun._sum_thm1,
            "thm2": jrun._sum_thm2, "sec52": jrun._sum_sec52}
    for exp, exp_rows in by_exp.items():
        got = paper.summary(exp, exp_rows)
        assert got == jsum[exp]({"rows": exp_rows}), exp
        assert got, exp
    names = dict(paper.summary("fig1", rows))
    assert "rounds_to_loss1.2_50_Adam_global" in names
    assert "loss_at_r10_50_SGD" in names
    assert {n for n, _ in paper.summary("thm1", by_exp["thm1"])} == {
        "ball_ratio_gamma_4x", "ball_ratio_M_4x", "transient_rate_measured",
        "transient_rate_bound_per_round"}


def test_paper_cli_runs_sec52_on_cpu(capsys):
    out = paper.main(["--exp", "sec52", "--device", "cpu", "--rounds", "2"])
    rows = out["sec52"]["rows"]
    assert len(rows) == 6
    assert out["sec52"]["summary"] == dict(jrun._sum_sec52({"rows": rows}))
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 7 and '"summary"' in printed[-1]


def test_paper_cli_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper.main(["--exp", "sec52"])


# --------------------------------------------------------------------------- #
# the presets on the quadratic against the pre-refactor oracles
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def problem():
    return jsyn.QuadraticProblem.make(d=24, M=4, mu=0.5, L=5.0, sigma=0.3,
                                      seed=0)


def _losses(problem):
    Q32, b32 = (np.asarray(a, np.float32) for a in (problem.Q, problem.b))
    jQ, jb = jnp.asarray(Q32), jnp.asarray(b32)
    tQ, tb = torch.from_numpy(Q32), torch.from_numpy(b32)

    def jloss(params, micro):
        x = params["x"]
        return 0.5 * (x - jb[0]) @ jQ[0] @ (x - jb[0]) + micro["z"] @ x

    def tloss(params, micro):
        x = params["x"]
        return 0.5 * (x - tb[0]) @ tQ[0] @ (x - tb[0]) + micro["z"] @ x

    return jloss, tloss


def _run_pair(problem, jstep, jstate, tstep, tstate, rounds=6, H=5):
    """Both rounds on the same batches and keys; yields the two states."""
    ql = jloader.QuadraticLoader(problem, seed=0)
    for k in _round_keys(0, rounds):
        nb = ql.round_batch(H)
        jstate, _ = jstep(jstate, {a: jnp.asarray(v) for a, v in nb.items()},
                          k)
        tstate, _ = tstep(tstate, {a: torch.from_numpy(v).to(
            torch.long if v.dtype.kind == "i" else torch.float32)
            for a, v in nb.items()}, JaxStream(k))
        yield jax.device_get(jstate), tstate


def _assert_leaves_close(got, want, keys):
    for key in keys:
        g, w = got, want
        for part in key.split("/"):
            g, w = g[part], w[part]
        w = np.asarray(w)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=ORACLE_ULPS * EPS * scale,
                                   err_msg=key)


SAVIC_CASES = {
    "adam-global-momentum": (dict(kind="adam", alpha=1e-2),
                             dict(gamma=0.03, beta1=0.9)),
    "oasis-local": (dict(kind="oasis", alpha=1e-2),
                    dict(gamma=0.03, beta1=0.5, scaling="local")),
    "rmsprop-avg-local-stat": (dict(kind="rmsprop", alpha=1e-2),
                               dict(gamma=0.03, beta1=0.0,
                                    stat_source="avg_local")),
}


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("case", list(SAVIC_CASES))
def test_savic_preset_matches_the_prerefactor_oracle(problem, case, fused):
    """The port's SAVIC preset (tree loop, or the fused loop on K1's plain
    version) against ``_reference_savic`` with ``use_fused_kernel`` set the
    same way (on: its per-leaf K2 in interpret mode)."""
    pc_kw, sv_kw = SAVIC_CASES[case]
    jloss, tloss = _losses(problem)
    jpc = JPrecondConfig(**pc_kw)
    jsv = ref_savic.SavicConfig(**sv_kw, use_fused_kernel=fused)
    pc, sv = PrecondConfig(**pc_kw), SavicConfig(**sv_kw,
                                                 use_fused_kernel=fused)
    jstep = jax.jit(ref_savic.build_round_step(jloss, jpc, jsv))
    jstate = ref_savic.init_state(jax.random.PRNGKey(0),
                                  lambda k: {"x": jnp.zeros(24)}, jpc, jsv, 4)
    tstate = state_from_jax(jax.device_get(jstate), "cpu")
    tstep = savic.build_round_step(tloss, pc, sv)
    keys = ["params/x", "mom/x"] + (["precond/d/x"] if "d" in
                                    tstate["precond"] else [])
    for js, ts in _run_pair(problem, jstep, jstate, tstep, tstate):
        _assert_leaves_close(ts, js, keys)


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("server_opt", ["adagrad", "adam", "yogi"])
def test_fedopt_preset_matches_the_prerefactor_oracle(problem, server_opt,
                                                      fused):
    """The port's FedOpt preset against ``_reference_fedopt`` (the monolith
    averaged per-client deltas, the engine averages post-step params)."""
    jloss, tloss = _losses(problem)
    kw = dict(server_opt=server_opt, eta=0.1, eta_l=0.02, tau=1e-2)
    jcfg = ref_fedopt.FedOptConfig(**kw)
    cfg = fedopt.FedOptConfig(**kw, use_fused_kernel=fused)
    jstep = jax.jit(ref_fedopt.build_round_step(jloss, jcfg))
    jstate = ref_fedopt.init_state(jax.random.PRNGKey(0),
                                   lambda k: {"x": jnp.zeros(24)}, jcfg)
    tstate = state_from_jax(jax.device_get(jstate), "cpu")
    tstep = fedopt.build_round_step(tloss, cfg)
    for js, ts in _run_pair(problem, jstep, jstate, tstep, tstate):
        _assert_leaves_close(ts, js, ["params/x", "m/x", "v/x"])


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("method", list(engine.METHODS))
def test_engine_presets_match_the_prerefactor_oracle(problem, method, fused):
    """Every ``engine.method_spec`` preset against ``_reference_engine``'s,
    ``use_fused_kernel`` the same on both (savic and local-adam reach the
    reference's K2 with it on)."""
    jloss, tloss = _losses(problem)
    kw = dict(gamma=0.03, eta_l=0.02, eta=0.05, tau=1e-2,
              use_fused_kernel=fused)
    jspec = ref_engine.method_spec(method, **kw)
    spec = engine.method_spec(method, **kw)
    jstep = jax.jit(ref_engine.build_round_step(jloss, jspec))
    jstate = ref_engine.init_state(jax.random.PRNGKey(0),
                                   lambda k: {"x": jnp.zeros(24)}, jspec, 4)
    tstate = state_from_jax(jax.device_get(jstate), "cpu")
    tstep = engine.build_round_step(tloss, spec)
    keys = ["params/x", "mom/x"]
    keys += ["precond/d/x"] if "d" in tstate["precond"] else []
    keys += ["server/m/x", "server/v/x"] if "server" in tstate else []
    for js, ts in _run_pair(problem, jstep, jstate, tstep, tstate):
        _assert_leaves_close(ts, js, keys)
