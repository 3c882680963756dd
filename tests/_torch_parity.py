"""Shared harness of the port's round-parity tests: reduced qwen2-0.5b on
both packages from one starting state (carried across by
``repro_torch.bridge``), byte-identical round batches, and the reference's
round keys ``PRNGKey(r)`` replayed into the port through ``JaxStream``.
The tolerances are stated and argued in tests/test_torch_engine.py;
``compression_err`` (a sum of squared residuals, summed sequentially in fp32
by XLA's CPU ``vdot``) is held at 1e-3 relative.

The Section-5 quadratic harness (``quad_*``) runs the reference's round
tests' problem (d = 24, M = 4) on both packages the same way, with the
reference's key chain ``key, k = split(key)`` from ``PRNGKey(1)``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_rng_replay import JaxStream
from repro.configs import get_config as jget_config
from repro.core import engine as jeng
from repro.data import LMRoundLoader as JLoader
from repro.data import QuadraticLoader, QuadraticProblem
from repro.data import TokenStream as JStream
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import state_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.models import ModelCallConfig, build
from repro_torch.utils.tree import tree_paths

ARCH = "qwen2-0.5b"
M, H, B, S, ROUNDS = 2, 2, 1, 8, 2


@functools.lru_cache(maxsize=None)
def models():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                            reduced=True)
    # remat off on both sides: it changes nothing numerically (pinned in
    # test_torch_models.py) and halves the reference's compile time
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, remat=False))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=False))
    return jcfg, jm, tm


def batches():
    jcfg, _, _ = models()
    loader = JLoader(JStream(jcfg.vocab_size, seed=0), M, B)
    return [loader.round_batch(r, H, S) for r in range(ROUNDS)]


def run_jax(jspec):
    _, jm, _ = models()
    state = jeng.init_state(jax.random.PRNGKey(0), jm.init, jspec, M)
    init = jax.device_get(state)
    step = jax.jit(jeng.build_round_step(jm.loss, jspec))
    mets = []
    for r, nb in enumerate(batches()):
        state, met = step(state, jax.tree.map(jnp.asarray, nb),
                          jax.random.PRNGKey(r))
        mets.append(jax.device_get(met))
    return init, jax.device_get(state), mets


def run_port(spec, init):
    """The port's rounds from the reference's initial state, replaying the
    reference's round keys ``PRNGKey(r)`` through ``JaxStream``."""
    _, _, tm = models()
    state = state_from_jax(init, "cpu")
    step = engine.build_round_step(tm.loss, spec)
    mets = []
    for r, nb in enumerate(batches()):
        state, met = step(state, {k: torch.from_numpy(v).long()
                                  for k, v in nb.items()},
                          JaxStream(jax.random.PRNGKey(r)))
        mets.append(met)
    return state, mets


def _entry(path):
    """The state entry a leaf belongs to: params, mom, precond/d, server/m,
    server/v."""
    head = path.split("/")
    return "/".join(head[:2]) if head[0] in ("precond", "server") \
        else head[0]


def assert_state_close(got, want, tol=1e-5, flips=False):
    """Every float leaf within ``tol`` of its scale: the largest magnitude in
    its state entry, or for server m and the EF residual (both built from
    Δ = x' − x, which cancels to ulps of x) the matching params leaf's.

    ``flips``: int8-stochastic rounds. floor(v + u) flips q by one where the
    two packages' v differ in the last bits at an integer boundary, which
    moves that element by one quantum absmax|Δ|/127. Up to 1e-4 of a leaf's
    elements (at least one) may then differ by up to 2e-4 of the scale: the
    round deltas here stay below 2.5 % of the params scale.
    """
    gd, wd = dict(tree_paths(got)), dict(jtree_paths(want))
    assert gd.keys() == wd.keys()
    scale = {}
    for k, w in wd.items():
        scale[_entry(k)] = max(scale.get(_entry(k), 0.0),
                               float(np.abs(np.asarray(w)).max()))
    for k, w in wd.items():
        w = np.asarray(w)
        g = gd[k].detach().numpy()
        assert g.shape == w.shape, k
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        sc = scale[_entry(k)]
        for head in ("server/m/", "ef/"):
            if k.startswith(head):
                sc = np.abs(np.asarray(wd["params/" + k[len(head):]])).max()
        if flips:
            off = np.abs(g - w) > tol * sc
            assert off.sum() <= max(1, int(1e-4 * w.size)), \
                (k, int(off.sum()), w.size)
            np.testing.assert_allclose(g, w, rtol=0, atol=20 * tol * sc,
                                       err_msg=k)
            g = np.where(off, w, g)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * sc, err_msg=k)


def assert_metrics_close(got, want, tol=1e-5, err_tol=1e-3):
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]),
                                   rtol=tol)
        np.testing.assert_allclose(g["loss_per_client"].numpy(),
                                   np.asarray(w["loss_per_client"]), rtol=tol)
        np.testing.assert_allclose(float(g["client_drift"]),
                                   float(w["client_drift"]), rtol=10 * tol)
        assert ("step_norm" in g) == ("step_norm" in w)
        if "step_norm" in w:
            np.testing.assert_allclose(float(g["step_norm"]),
                                       float(w["step_norm"]), rtol=100 * tol)
        assert ("compression_err" in g) == ("compression_err" in w)
        if "compression_err" in w:
            np.testing.assert_allclose(float(g["compression_err"]),
                                       float(w["compression_err"]),
                                       rtol=err_tol)


# --------------------------------------------------------------------------- #
# The Section-5 quadratic on both packages
# --------------------------------------------------------------------------- #

QUAD_KW = dict(gamma=0.01, alpha=1e-2, eta_l=0.01, eta=0.05)


@functools.lru_cache(maxsize=None)
def quad_problem():
    return QuadraticProblem.make(d=24, M=4, mu=0.5, L=5.0, sigma=0.3, seed=0)


def quad_losses(problem=None):
    """(reference loss, port loss) of f_0(x) + z·x; a ``head`` leaf, where
    the params have one, enters with zero gradient (so only a sync could
    change it)."""
    problem = problem or quad_problem()
    Qj, bj = (jnp.asarray(problem.Q, jnp.float32),
              jnp.asarray(problem.b, jnp.float32))
    Qt, bt = (torch.tensor(problem.Q, dtype=torch.float32),
              torch.tensor(problem.b, dtype=torch.float32))

    def jloss(params, micro):
        x = params["x"]
        out = 0.5 * (x - bj[0]) @ Qj[0] @ (x - bj[0]) + micro["z"] @ x
        return out + 0.0 * jnp.sum(params["head"]) if "head" in params \
            else out

    def tloss(params, micro):
        x = params["x"]
        out = 0.5 * (x - bt[0]) @ Qt[0] @ (x - bt[0]) + micro["z"] @ x
        return out + 0.0 * params["head"].sum() if "head" in params else out

    return jloss, tloss


def quad_init(params=None):
    """A reference init function of fixed params (default x = 0)."""
    params = params or {"x": np.zeros(24, np.float32)}
    return lambda key: {k: jnp.asarray(v) for k, v in params.items()}


def quad_batches(rounds, H, seed=0):
    """(numpy round batches, reference round keys)."""
    loader = QuadraticLoader(quad_problem(), seed=seed)
    key, out = jax.random.PRNGKey(seed + 1), []
    for _ in range(rounds):
        key, k = jax.random.split(key)
        out.append(({n: np.asarray(v) for n, v in
                     loader.round_batch(H).items()}, k))
    return out


def quad_torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def quad_run_jax(jspec, rounds=4, H=3, init=None, objective=None,
                 edit=None):
    """The reference's rounds (its tree path unless ``jspec`` fuses):
    (initial state, final state, per-round metrics), numpy. ``edit(state)``
    changes the initial state in place (e.g. per-client personal values)."""
    jloss = objective.base_loss if objective is not None else \
        quad_losses()[0]
    state = jeng.init_state(jax.random.PRNGKey(0), init or quad_init(),
                            jspec, 4)
    if edit is not None:
        edit(state)
    init_np = jax.device_get(state)
    kw = {"objective": objective} if objective is not None else {}
    step = jax.jit(jeng.build_round_step(jloss, jspec, **kw))
    mets = []
    for nb, k in quad_batches(rounds, H):
        state, met = step(state, jax.tree.map(jnp.asarray, nb), k)
        mets.append(jax.device_get(met))
    return init_np, jax.device_get(state), mets


def quad_port_state(spec, params=None):
    """The port's own initial state of ``params`` (default x = 0), M = 4."""
    params = params or {"x": torch.zeros(24)}
    return engine.init_state(torch.Generator(), lambda g: {
        k: v.clone() for k, v in params.items()}, spec, 4)


def quad_run_port(spec, init_np=None, rounds=4, H=3, objective=None):
    """The port's rounds from the reference's initial state (default: the
    port's own, x = 0), on the reference's batches and replayed keys:
    (final state, metrics)."""
    tloss = objective.base_loss if objective is not None else \
        quad_losses()[1]
    state = state_from_jax(init_np, "cpu") if init_np is not None else \
        quad_port_state(spec)
    step = engine.build_round_step(tloss, spec, objective=objective)
    mets = []
    for nb, k in quad_batches(rounds, H):
        state, met = step(state, quad_torch_batch(nb), JaxStream(k))
        mets.append(met)
    return state, mets


def assert_quad_metrics(got, want, keys=("loss", "loss_per_client",
                                         "client_drift", "staleness",
                                         "step_norm", "compression_err"),
                        rtol=1e-5):
    """Float metrics to ``rtol`` (client drift and step norm, built from
    differences of nearly equal params, to 10× and 100×); present in both
    or in neither."""
    scale = {"client_drift": 10, "step_norm": 100}
    for g, w in zip(got, want):
        for k in keys:
            assert (k in g) == (k in w), k
            if k in w:
                np.testing.assert_allclose(
                    np.asarray(g[k], dtype=np.float64),
                    np.asarray(w[k], dtype=np.float64),
                    rtol=rtol * scale.get(k, 1), atol=1e-7, err_msg=k)
