"""Cases of the port's mesh tests, shared by the test files and the worker
that runs them on CPU gloo ranks (``tests/_torch_mesh_worker.py``).

The engine cases train the Fig. 1 MLP (``repro_torch.models.mlp``: 192 → 128
→ 10) on synthetic classification data split iid over the plan's M clients,
2 rounds of H = 2 steps on microbatches of 8 rows, from the reference's
init (``PRNGKey(0)``) with the reference's round keys (``key, k =
split(key)`` from ``PRNGKey(1)``) replayed through ``JaxStream``. The MLP's
leaves are laid out like a model's: ``w1`` (fsdp, model), ``b1`` (model),
``w2`` (model, fsdp), ``b2`` over (fsdp + model) jointly, which on the plain
(2, 2) plan is 10 over 4 shards: the uneven fallback replicates it.

The feature cases run the sync's compression on plans whose shard axes
split the leaves (int8 + EF, top-k + EF, rand-k; plain's ``b2`` is the
replicated fallback; the adaptive server's top-|m| ``sync_k``), the controller (top-k + EF, a FIFO of 2, one client
slow enough to sit a round out) and the classification objectives on plans
that split the microbatch, at ``labeled_frac`` 0.5 (consistency; and
pseudo-label at a gate the random init opens for some rows).
``record_compression`` keeps every rank's compression calls so that
``verify_masks`` can hold each kept-k mask against ``_compress_leaf`` on
the run's own gathered deltas.

The one-device cases are the reference's ``test_one_device_shard_plan_bitwise``:
the Section-5 quadratic (d = 24, M = 4 on one rank) on a 1×1 mesh.

The model cases are reduced qwen2-0.5b, mamba2-1.3b and qwen2-moe-a2.7b
under ``paper`` on (2, 2), M 2, H 2, b 2, S 32, from the reference's init.
"""
import contextlib
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_rng_replay import JaxStream
from repro_torch.bridge import params_from_jax
from repro_torch.core import engine, objectives
from repro_torch.data import ClassificationData, FederatedLoader, \
    QuadraticLoader, QuadraticProblem, iid_partition, labeled_mask
from repro_torch.models import mlp
from repro_torch.sharding import PartitionSpec as P
from repro_torch.sharding import plan_for
from repro_torch.utils.flatten import ShardedFlatPlan
from repro_torch.utils.tree import tree_map, tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS, H, B = 2, 2, 8
KW = dict(gamma=2e-3, alpha=1e-2, eta_l=0.01, eta=0.05)
QUAD_KW = dict(gamma=0.01, alpha=1e-2, eta_l=0.01, eta=0.05)
N_DATA = 600


@dataclasses.dataclass(frozen=True)
class Case:
    id: str
    shape: tuple                 # mesh shape
    mode: str                    # paper | paper_fsdp | plain | diloco
    method: str = "savic"
    knobs: str = ""              # "" | "knobs" | "int8-fifo" | FEATURES

    @property
    def axes(self):
        return ("pod", "data", "model") if len(self.shape) == 3 \
            else ("data", "model")

    @property
    def plan(self):
        return plan_for(self.mode, len(self.shape) == 3)

    @property
    def n_clients(self):
        sizes = dict(zip(self.axes, self.shape))
        return int(np.prod([sizes[a] for a in self.plan.client])) \
            if self.plan.client else 1


METHODS = ("savic", "fedavg", "fedadagrad", "fedadam", "fedyogi",
           "local-adam")
CASES = (
    [Case(f"paper-2x2-{m}", (2, 2), "paper", m) for m in METHODS]
    + [Case(f"fsdp-2x2-{m}", (2, 2), "paper_fsdp", m) for m in METHODS]
    + [Case("paper-2x1-savic", (2, 1), "paper"),
       Case("paper-2x1-knobs", (2, 1), "paper", knobs="knobs"),
       Case("paper-2x1-int8-fifo", (2, 1), "paper", knobs="int8-fifo"),
       Case("paper-2x2-knobs", (2, 2), "paper", knobs="knobs"),
       Case("fsdp-2x2-knobs", (2, 2), "paper_fsdp", knobs="knobs"),
       Case("plain-2x2-savic", (2, 2), "plain"),
       Case("plain-2x2-knobs", (2, 2), "plain", knobs="knobs"),
       Case("diloco-2x1x2-savic", (2, 1, 2), "diloco"),
       Case("diloco-2x1x2-knobs", (2, 1, 2), "diloco", knobs="knobs"),
       Case("paper-2x2-int8-ef", (2, 2), "paper", knobs="int8-ef"),
       Case("fsdp-2x2-topk-ef", (2, 2), "paper_fsdp", knobs="topk-ef"),
       Case("plain-2x2-randk", (2, 2), "plain", knobs="randk"),
       Case("plain-2x2-int8-ef", (2, 2), "plain", knobs="int8-ef"),
       Case("paper-2x2-ctrl", (2, 2), "paper", knobs="ctrl"),
       Case("fsdp-2x2-objective", (2, 2), "paper_fsdp",
            knobs="consistency"),
       Case("plain-2x2-objective", (2, 2), "plain", knobs="pseudo-label"),
       Case("plain-2x2-fedadam-server-k", (2, 2), "plain", "fedadam",
            knobs="server-k")])
CASE_IDS = [c.id for c in CASES]
FEATURES = ("int8-ef", "topk-ef", "randk", "ctrl", "consistency",
            "pseudo-label", "server-k")
FEATURE_IDS = [c.id for c in CASES if c.knobs in FEATURES]
OBJECTIVES = ("consistency", "pseudo-label")
LABELED_FRAC = 0.5
PSEUDO_THRESHOLD = 0.2
# client 1 is 2.6× slower: at H_t = 1 it sits the round out (H_m = 0)
CTRL_KW = dict(enabled=True, h_min=1, h_max=H, noise_target=1e-3,
               buffer_max=2, step_times=(1.0, 2.6))
ONE_DEVICE_METHODS = ("savic", "fedadam", "local-adam")


def _knob_kw(case, controller_spec):
    M = case.n_clients
    if case.knobs == "knobs":
        # half the clients sampled, client M-1 stops after one step
        return dict(participation=0.5, local_steps=(H,) * (M - 1) + (1,))
    if case.knobs == "int8-fifo":
        return dict(compression="int8-stochastic", error_feedback=True,
                    async_buffer=2)
    if case.knobs == "int8-ef":
        return dict(compression="int8-stochastic", error_feedback=True)
    if case.knobs == "topk-ef":
        return dict(compression="topk", compression_k=0.1,
                    error_feedback=True)
    if case.knobs == "randk":
        return dict(compression="randk", compression_k=0.1)
    if case.knobs == "server-k":
        # the adaptive server's m/v kept on one shared top-|m| index set
        return dict(server_sync_k=0.5)
    if case.knobs == "ctrl":
        return dict(compression="topk", compression_k=0.1,
                    error_feedback=True, async_buffer=2,
                    controller=controller_spec(**CTRL_KW))
    return {}


def _clip_wd(spec, case):
    if case.knobs != "knobs":
        return spec
    return dataclasses.replace(spec, client=dataclasses.replace(
        spec.client, grad_clip=0.5, weight_decay=1e-3))


def port_spec(case, fused):
    return _clip_wd(engine.method_spec(
        case.method, use_fused_kernel=fused, **KW,
        **_knob_kw(case, engine.ControllerSpec)), case)


def jax_spec(case):
    from repro.core import engine as jeng
    return _clip_wd(jeng.method_spec(
        case.method, **KW, **_knob_kw(case, jeng.ControllerSpec)), case)


def port_objective(case):
    if case.knobs not in OBJECTIVES:
        return None
    return objectives.classification_objective(objectives.ObjectiveSpec(
        kind=case.knobs, pseudo_threshold=PSEUDO_THRESHOLD), mlp.logits)


def jax_objective(case):
    if case.knobs not in OBJECTIVES:
        return None
    from repro.core import objectives as jobj
    return jobj.classification_objective(jobj.ObjectiveSpec(
        kind=case.knobs, pseudo_threshold=PSEUDO_THRESHOLD), jax_mlp_logits)


# --------------------------------------------------------------------------- #
# the MLP problem
# --------------------------------------------------------------------------- #


def mlp_init_np():
    def init(key):
        k1, k2 = jax.random.split(key)
        return {"w1": jax.random.normal(k1, (192, 128)) * 192 ** -0.5,
                "b1": jnp.zeros((128,)),
                "w2": jax.random.normal(k2, (128, 10)) * 128 ** -0.5,
                "b2": jnp.zeros((10,))}
    return jax.device_get(init(jax.random.PRNGKey(0)))


def jax_mlp_logits(params, x):
    h = jax.nn.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def jax_mlp_loss(params, batch):
    logits = jax_mlp_logits(params, batch["x"])
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, batch["y"][:, None], 1)[:, 0]
    return (logz - gold).mean()


def round_inputs(case):
    """[(numpy round batch, reference round key)] for the case's M."""
    data = ClassificationData.make(n=N_DATA, n_classes=10, seed=0)
    parts = iid_partition(N_DATA, case.n_clients, seed=0)
    labeled = labeled_mask(data.y, LABELED_FRAC, seed=0) \
        if case.knobs in OBJECTIVES else None
    loader = FederatedLoader(data.x, data.y.astype(np.int32), parts,
                             batch_size=B, seed=0, labeled=labeled)
    key, out = jax.random.PRNGKey(1), []
    for _ in range(ROUNDS):
        key, k = jax.random.split(key)
        out.append((loader.round_batch(H), k))
    return out


def torch_batch(nb):
    out = {"x": torch.from_numpy(nb["x"]),
           "y": torch.from_numpy(nb["y"].astype(np.int64))}
    if "labeled" in nb:
        out["labeled"] = torch.from_numpy(nb["labeled"])
    return out


def mlp_pspecs(plan):
    mdl = tuple(plan.model) or None
    fsdp = tuple(plan.batch) if plan.fsdp_params else ()
    both = tuple(a for a in ("pod", "data", "model")
                 if a in fsdp + tuple(plan.model)) or None
    fsdp = fsdp or None
    return {"w1": P(fsdp, mdl), "b1": P(mdl), "w2": P(mdl, fsdp),
            "b2": P(both)}


def mlp_shard_plan(case, mesh):
    plan = case.plan
    axes = tuple(plan.model) + (tuple(plan.batch) if plan.fsdp_params
                                else ())
    one = {k: torch.empty(v.shape, device="meta")
           for k, v in mlp_init_np().items()}
    return ShardedFlatPlan.build(mesh, one, mlp_pspecs(plan), axes,
                                 client=plan.client or None,
                                 batch=plan.batch)


def run_port(case, fused, shard_plan=None):
    """The case's rounds on the port: (full final state, per-round metrics)
    as numpy; on a mesh in every rank, the state gathered."""
    spec = port_spec(case, fused)
    step = engine.build_round_step(mlp.loss, spec, port_objective(case),
                                   shard_plan=shard_plan)
    init = params_from_jax(mlp_init_np(), "cpu")
    state = engine.init_state(torch.Generator(), lambda g: {
        k: v.clone() for k, v in init.items()}, spec, case.n_clients)
    if shard_plan is not None:
        state = engine.shard_state(state, shard_plan)
    mets = []
    for nb, k in round_inputs(case):
        state, met = step(state, torch_batch(nb), JaxStream(k))
        mets.append(to_numpy(met))
    if shard_plan is not None:
        state = engine.gather_state(state, shard_plan)
    return to_numpy(state), mets


def run_jax(case):
    from repro.core import engine as jeng
    jspec = jax_spec(case)
    state = jeng.init_state(jax.random.PRNGKey(0), lambda k: {
        n: jnp.asarray(v) for n, v in mlp_init_np().items()}, jspec,
        case.n_clients)
    step = jax.jit(jeng.build_round_step(jax_mlp_loss, jspec,
                                         objective=jax_objective(case)))
    mets = []
    for nb, k in round_inputs(case):
        state, met = step(state, jax.tree.map(jnp.asarray, nb), k)
        mets.append(jax.device_get(met))
    return jax.device_get(state), mets


@contextlib.contextmanager
def record_compression(calls):
    """Append every ``engine._compress_leaf`` call on a split leaf (its
    input deltas, output, stream, kept fraction, rows and path) to
    ``calls`` while entered."""
    orig = engine._compress_leaf

    def rec(spec, x, stream, k_frac=None, rows=None, block=None):
        u = x.clone()
        c = orig(spec, x, stream, k_frac, rows, block)
        if block is not None:
            calls.append((spec, u, c.clone(), stream, k_frac, rows, block))
        return c
    engine._compress_leaf = rec
    try:
        yield calls
    finally:
        engine._compress_leaf = orig


def verify_masks(calls):
    """Every recorded top-k / rand-k call against ``_compress_leaf`` on the
    gathered full deltas of this rank's clients (a collective: every rank
    calls it with its own records, in the same order): the rank's block of
    the full compression, bit for bit, and exactly kc entries kept in each
    client row of the full leaf that has kc nonzero deltas. Returns
    (calls, rows) checked."""
    rows_checked = 0
    for spec, u, c, stream, k_frac, rows, (pl, path) in calls:
        if spec.op not in ("topk", "randk"):
            continue
        full_u = pl.full_leaf(path, u, lead=1)
        full_c = pl.full_leaf(path, c, lead=1)
        want = engine._compress_leaf(spec, full_u, stream, k_frac, rows)
        mine = pl.local_leaf(path, want, lead=1)
        assert torch.equal(c, mine), path
        assert torch.equal(full_c, want), path
        kc, _ = engine._kept_count(spec, math.prod(pl.full_shape(path)),
                                   k_frac)
        # exactly kc kept where a row has kc nonzero deltas (a client
        # that sat the round out sends zeros: top-k then keeps zeros)
        nnz = lambda t: torch.count_nonzero(t.reshape(t.shape[0], -1), dim=1)
        kept, live = nnz(want), nnz(full_u)
        if spec.op == "topk":
            assert torch.equal(kept, live.clamp_max(kc)), (path, kept, kc)
        else:           # rand-k's picks fall on zeros too, but not here
            dense = live == full_u[0].numel()
            assert bool((kept[dense] == kc).all()), (path, kept, kc)
        rows_checked += want.shape[0]
    return len(calls), rows_checked


def to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy()
                    if isinstance(t, torch.Tensor) else t, tree)


# --------------------------------------------------------------------------- #
# the one-device quadratic (the reference's 1-device shard-plan test)
# --------------------------------------------------------------------------- #


def quad_problem():
    return QuadraticProblem.make(d=24, M=4, mu=0.5, L=5.0, sigma=0.3, seed=0)


def quad_run(method, fused, shard_plan=None, rounds=3, Hq=3):
    prob = quad_problem()
    Q = torch.tensor(prob.Q, dtype=torch.float32)
    b = torch.tensor(prob.b, dtype=torch.float32)

    def loss(params, micro):
        x = params["x"]
        return 0.5 * (x - b[0]) @ Q[0] @ (x - b[0]) + micro["z"] @ x

    spec = engine.method_spec(method, **QUAD_KW, use_fused_kernel=fused)
    step = engine.build_round_step(loss, spec, shard_plan=shard_plan)
    state = engine.init_state(torch.Generator(),
                              lambda g: {"x": torch.zeros(24)}, spec, 4)
    if shard_plan is not None:
        state = engine.shard_state(state, shard_plan)
    loader = QuadraticLoader(prob, seed=0)
    key = jax.random.PRNGKey(1)
    for _ in range(rounds):
        key, k = jax.random.split(key)
        nb = {n: torch.from_numpy(np.asarray(v))
              for n, v in loader.round_batch(Hq).items()}
        state, met = step(state, nb, JaxStream(k))
    if shard_plan is not None:
        state = engine.gather_state(state, shard_plan)
    return to_numpy(state), float(met["loss"])


def quad_shard_plan(mesh):
    return ShardedFlatPlan.build(mesh, {"x": torch.empty(24, device="meta")},
                                 {"x": P("model")}, ("model",),
                                 client=("data",))


# --------------------------------------------------------------------------- #
# the tests' side: the spawn, and the comparisons
# --------------------------------------------------------------------------- #


def run_worker(suite, outdir, timeout):
    """Run ``tests/_torch_mesh_worker.py suite outdir`` under ``timeout``
    seconds and load what its rank 0 wrote."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests",
                                                     "_torch_mesh_worker.py"),
                        suite, str(outdir)], capture_output=True, text=True,
                       env=env, timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-8000:]
    assert f"ALL-OK {suite}" in r.stdout
    return torch.load(os.path.join(outdir, f"{suite}.pt"),
                      weights_only=False)




def _leaves(state):
    return [(p, np.asarray(x)) for p, x in tree_paths(state)]


def assert_states_close(got, want, rtol=1e-5, atol_scale=1e-5, atol=0.0,
                        bitwise=False):
    """Leaf by leaf; the EF residual's and the staleness FIFO's scale is the
    matching params leaf's (u − C(u) and the averaged deltas cancel to ulps
    of the params)."""
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    wd = dict(w)
    for (p, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, p
        if bitwise:
            np.testing.assert_array_equal(a, b, err_msg=p)
        else:
            head, rest = p.split("/", 1) if "/" in p else (p, "")
            ref = wd["params/" + rest] if head in ("ef", "buffer") else b
            scale = float(np.abs(ref).max()) if ref.size else 0.0
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=max(atol_scale * scale, atol),
                                       err_msg=p)


METRIC_SCALE = {"client_drift": 10, "step_norm": 100}
# the feature cases' compression error is a sum of squares of round deltas
# (differences of nearly equal params), as the drift is
FEATURE_SCALE = dict(METRIC_SCALE, compression_err=10)


def assert_metrics_close(got, want, rtol=1e-5, scale=METRIC_SCALE):
    for g, w in zip(got, want):
        for k in ("loss", "loss_per_client", "client_drift", "step_norm",
                  "compression_err", "staleness"):
            assert (k in g) == (k in w), k
            if k in w:
                np.testing.assert_allclose(
                    np.asarray(g[k], np.float64), np.asarray(w[k], np.float64),
                    rtol=rtol * scale.get(k, 1), atol=1e-7, err_msg=k)


@contextlib.contextmanager
def one_thread():
    """Run as the mesh's ranks do, on one intra-op thread: CPU matmuls and
    reductions sum in an order that depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
