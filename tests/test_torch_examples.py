"""The port's examples (``examples/quickstart_torch.py``,
``examples/federated_heterogeneity_torch.py``) against the reference's own
API calls, made here: the same numpy problem and data, the reference's MLP
init carried across by ``repro_torch.bridge``, its round keys replayed
through ``JaxStream``. Three rounds each.

Tolerances: losses, distances and drifts to 1e-5 relative (fp32 rounds of
the same arithmetic; the OASIS methods' Hessian-vector products are taken
in another order, which the paper runners' parity tests hold to the same
1e-5); test accuracy within 2 of the 1000 held-out examples (an argmax on
a near tie may flip).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_rng_replay import JaxStream
from repro.core import AsyncSpec as JAsyncSpec
from repro.core import PrecondConfig as JPrecond
from repro.core import SavicConfig as JSavic
from repro.core import savic as jsavic
from repro.data import ClassificationData as JData
from repro.data import FederatedLoader as JFedLoader
from repro.data import QuadraticLoader as JQuadLoader
from repro.data import QuadraticProblem as JQuad
from repro.data import main_class_partition as jpartition
from repro.data.federated import local_steps_from_times as jlocal_steps
from repro.data.federated import sample_step_times as jstep_times
from repro_torch.bridge import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _round_keys(seed, rounds):
    """``key, k = split(key)`` from ``PRNGKey(seed)``, as the examples."""
    key, ks = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, k = jax.random.split(key)
        ks.append(k)
    return ks


def _jax_quickstart_rows(rounds):
    """``examples/quickstart.py``'s loop on the reference's API, one row a
    round."""
    problem = JQuad.make(d=32, M=8, mu=0.5, L=8.0, sigma=0.5,
                         heterogeneity=2.0, seed=0)
    Q = jnp.asarray(problem.Q, jnp.float32)
    b = jnp.asarray(problem.b, jnp.float32)

    def loss_fn(params, micro):
        x = params["x"]
        Qm, bm = Q[micro["cid"]], b[micro["cid"]]
        return 0.5 * (x - bm) @ Qm @ (x - bm) + micro["z"] @ x

    pc = JPrecond(kind="adam", alpha=1e-2)
    sv = JSavic(gamma=0.005, beta1=0.9, scaling="global")
    step = jax.jit(jsavic.build_round_step(loss_fn, pc, sv))
    state = jsavic.init_state(jax.random.PRNGKey(0),
                              lambda k: {"x": jnp.zeros(32)}, pc, sv,
                              n_clients=8)
    loader = JQuadLoader(problem, seed=1)
    xstar = jnp.asarray(problem.x_star(), jnp.float32)
    rows = []
    for r, k in enumerate(_round_keys(2, rounds)):
        state, met = step(state, jax.tree.map(jnp.asarray,
                                              loader.round_batch(H=8)), k)
        x = jsavic.average_params(state)["x"]
        rows.append((r, float(met["loss"]), float(jnp.sum((x - xstar) ** 2)),
                     float(met["client_drift"])))
    return rows


def test_quickstart_rows_match_the_reference():
    got = _example("quickstart_torch").run(ROUNDS, "cpu")
    want = _jax_quickstart_rows(ROUNDS)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose(np.array(got)[:, 1:], np.array(want)[:, 1:],
                               rtol=1e-5)


def test_quickstart_main_prints_the_rows_and_the_rate(capsys):
    rows = _example("quickstart_torch").main(["--device", "cpu",
                                              "--rounds", str(ROUNDS)])
    out = capsys.readouterr().out
    assert len(rows) == ROUNDS
    assert "round   0" in out and f"round {ROUNDS - 1:3d}" in out
    assert "Theorem-1 contraction/step" in out


def _jax_fig1_init(D):
    def init(key):
        k1, k2 = jax.random.split(key)
        return {"w1": jax.random.normal(k1, (D, 128)) * D ** -0.5,
                "b1": jnp.zeros((128,)),
                "w2": jax.random.normal(k2, (128, 10)) * 128 ** -0.5,
                "b2": jnp.zeros((10,))}
    return init


def _jax_fig1_loss(params, batch):
    h = jax.nn.relu(batch["x"] @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, batch["y"][:, None], 1)[:, 0]
    return (logz - gold).mean()


def _jax_fig1_rows(args, methods):
    """``examples/federated_heterogeneity.py``'s loop on the reference's
    API (without its CSV, which it writes into results/)."""
    data = JData.make(n=8000, n_classes=10, seed=0)
    xte, yte = jnp.asarray(data.x[-1000:]), jnp.asarray(data.y[-1000:])
    with pytest.warns(UserWarning, match="ran dry"):
        parts = jpartition(data.y[:-1000], 10, args.frac, seed=0)
    local_steps = None
    asy = JAsyncSpec(buffer_rounds=args.async_buffer)
    step_times = jstep_times(args.het_model, 10, seed=0,
                             sigma=args.het_sigma)
    if args.het_model != "uniform":
        local_steps = tuple(int(h) for h in
                            jlocal_steps(step_times, args.h_local))
    init = _jax_fig1_init(data.x.shape[1])

    def accuracy(params):
        h = jax.nn.relu(xte @ params["w1"] + params["b1"])
        return float((jnp.argmax(h @ params["w2"] + params["b2"], -1)
                      == yte).mean())

    rows = []
    for name, (kind, scaling) in methods.items():
        pc = JPrecond(kind=kind, alpha=1e-2, beta2=0.999)
        sv = JSavic(gamma=0.002, beta1=0.9, scaling=scaling,
                    local_steps=local_steps, asynchrony=asy)
        step = jax.jit(jsavic.build_round_step(_jax_fig1_loss, pc, sv))
        state = jsavic.init_state(jax.random.PRNGKey(0), init, pc, sv, 10)
        loader = JFedLoader(data.x[:-1000], data.y[:-1000].astype(np.int32),
                            parts, batch_size=64, seed=0)
        for r, k in enumerate(_round_keys(1, args.rounds)):
            state, met = step(state, jax.tree.map(
                jnp.asarray, loader.round_batch(args.h_local)), k)
            rows.append((name, r, float(met["loss"]),
                         accuracy(jsavic.average_params(state))))
    init_np = jax.device_get(init(jax.random.PRNGKey(0)))
    return rows, init_np


@pytest.mark.parametrize("het_model,async_buffer", [("uniform", 0),
                                                    ("lognormal", 2)])
def test_federated_heterogeneity_rows_match_the_reference(het_model,
                                                          async_buffer,
                                                          tmp_path):
    ex = _example("federated_heterogeneity_torch")
    args = ex._parser().parse_args([
        "--rounds", str(ROUNDS), "--het-model", het_model,
        "--async-buffer", str(async_buffer), "--device", "cpu",
        "--out", str(tmp_path / "fig1.csv")])
    want, init_np = _jax_fig1_rows(args, ex.METHODS)
    init = params_from_jax(init_np, "cpu")
    ks = _round_keys(1, ROUNDS)
    with pytest.warns(UserWarning, match="ran dry"):
        got = ex.run(args, init_params=lambda g: {k: v.clone() for k, v
                                                  in init.items()},
                     streams=lambda r: JaxStream(ks[r]),
                     say=lambda *a: None)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[2], w[2], rtol=1e-5, err_msg=g[0])
        assert abs(g[3] - w[3]) <= 2 / 1000 + 1e-6, (g, w)


def test_federated_heterogeneity_writes_its_csv_outside_results(tmp_path):
    ex = _example("federated_heterogeneity_torch")
    assert os.path.relpath(ex.OUT, ROOT).split(os.sep)[0] == "examples"
    out = tmp_path / "rows.csv"
    with pytest.warns(UserWarning, match="ran dry"):
        rows = ex.main(["--rounds", "1", "--device", "cpu", "--out",
                        str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "method,round,loss,test_acc"
    assert len(lines) == 1 + len(rows) == 1 + len(ex.METHODS)
    assert all(np.isfinite(r[2]) for r in rows)
