"""Heterogeneous and asynchronous rounds in the port, held against the
reference (``repro.core.engine``, ``repro.data.federated``) and against
Python oracles: the port's counterpart of tests/test_heterogeneity.py.

Everything runs the Section-5 quadratic of the reference's tests (d = 24,
M = 4) on both packages from one starting state, on the same batches and
replayed keys (``_torch_parity.quad_*``), except the clip + weight decay +
H_m composition, which runs reduced qwen2-0.5b. The reference runs its tree
path.

Tolerances: state within 1e-5 of the largest magnitude in its entry
(``assert_state_close``), metrics 1e-5 relative (``assert_quad_metrics``),
H_m, step counters and step times exact; the clip + weight decay + H_m
composition at 1e-3 (the reference's CPU ``vdot`` in its clip, see
tests/test_torch_engine.py). The identity contracts (uniform H_m, B = 0) and
the truncated batch are bitwise within the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (QUAD_KW, assert_quad_metrics, assert_state_close,
                           quad_batches, quad_losses, quad_port_state,
                           quad_run_jax, quad_run_port, quad_torch_batch,
                           run_jax, run_port)
from repro.core import engine as jeng
from repro.core import savic as jsavic
from repro.core.preconditioner import PrecondConfig as JPrecond
from repro.data import federated as jfed
from repro_torch.core import engine, savic
from repro_torch.core.preconditioner import PrecondConfig
from repro_torch.data import federated as fed
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)


def _specs(method, fused=False, **kw):
    return (jeng.method_spec(method, **QUAD_KW, **kw),
            engine.method_spec(method, **QUAD_KW, use_fused_kernel=fused,
                               **kw))


def _port_states_equal(a, b):
    pa, pb = dict(tree_paths(a)), dict(tree_paths(b))
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


# --------------------------------------------------------------------------- #
# uniform H_m and a zero-depth buffer are the plain round, for all methods
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", engine.METHODS)
def test_uniform_hm_no_buffer_is_the_plain_round(method):
    """local_steps = (H,)·M and buffer_rounds = 0 give the plain round
    bitwise in the port, and the reference's within tolerance; no buffer
    leaf, no staleness metric."""
    H = 3
    jspec, spec = _specs(method, local_steps=(H,) * 4, async_buffer=0)
    init, want, wmets = quad_run_jax(jspec, H=H)
    got, gmets = quad_run_port(spec, init, H=H)
    plain, pmets = quad_run_port(_specs(method)[1], init, H=H)
    _port_states_equal(got, plain)
    for g, p in zip(gmets, pmets):
        assert torch.equal(g["loss"], p["loss"])
    assert "buffer" not in got and "staleness" not in gmets[-1]
    assert_state_close(got, want)
    assert_quad_metrics(gmets, wmets)


# --------------------------------------------------------------------------- #
# heterogeneous and buffered rounds against the reference
# --------------------------------------------------------------------------- #

CASES = {
    "savic-hm": dict(method="savic", pc_kind="identity", beta1=0.9,
                     local_steps=(1, 2, 4, 3)),
    "fedavg-hm": dict(method="fedavg", local_steps=(1, 2, 4, 3)),
    "local-adam-hm": dict(method="local-adam", local_steps=(1, 4, 2, 3)),
    "savic-global-adam-hm": dict(method="savic", local_steps=(2, 4, 1, 3)),
    "fedavg-async-constant-hm": dict(
        method="fedavg", local_steps=(1, 3, 2, 3), async_buffer=3),
    "fedavg-async-polynomial-hm": dict(
        method="fedavg", local_steps=(1, 3, 2, 3), async_buffer=3,
        staleness_weight="polynomial"),
    "fedadam-async-topk-ef": dict(
        method="fedadam", async_buffer=2, compression="topk",
        compression_k=0.5, error_feedback=True),
    "savic-async-int8-ef-hm": dict(
        method="savic", async_buffer=2, compression="int8-stochastic",
        error_feedback=True, local_steps=(3, 1, 2, 3)),
}


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("name", list(CASES))
def test_hetero_round_matches_reference(name, fused):
    """Four rounds of H = 4: frozen clients hold their step-H_m state to the
    sync, loss_per_client is each client's own last step, the FIFO and its
    staleness metric follow the reference's."""
    kw = dict(CASES[name])
    jspec, spec = _specs(kw.pop("method"), fused, **kw)
    init, want, wmets = quad_run_jax(jspec, H=4)
    got, gmets = quad_run_port(spec, init, H=4)
    assert_state_close(got, want, flips="int8" in name)
    assert_quad_metrics(gmets, wmets)
    if "local-adam" in name:
        # a frozen client's own D and step counter freeze too
        np.testing.assert_array_equal(got["precond"]["t"].numpy(),
                                      4 * np.asarray(kw["local_steps"]))


def test_fused_loop_launches_max_hm_per_round(monkeypatch):
    """Under H_m the fused loop makes one launch per local step in which any
    client is active: max_m H_m a round, so rounds × max_m H_m."""
    from repro_torch.kernels import ops as kops
    calls = []
    real = kops.fused_local_step
    monkeypatch.setattr(kops, "fused_local_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for hm, want in (((1, 2, 3, 2), 3), ((5, 5, 5, 5), 5), ((1, 1, 1, 1), 1)):
        calls.clear()
        quad_run_port(_specs("fedavg", True, local_steps=hm)[1], rounds=2,
                      H=5)
        assert len(calls) == 2 * want, (hm, len(calls))


# --------------------------------------------------------------------------- #
# Python oracles
# --------------------------------------------------------------------------- #


def _grad(x, micro):
    _, tloss = quad_losses()
    x = x.clone().requires_grad_(True)
    loss = tloss({"x": x}, micro)
    return float(loss.detach()), torch.autograd.grad(loss, x)[0]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_masked_loop_matches_python_oracle(momentum):
    """One round of H_m = (1, 2, 4, 3) equals a per-client loop that runs
    h_m[m] heavy-ball steps and averages; loss_per_client is each client's
    own last step."""
    h_m = (1, 2, 4, 3)
    if momentum:
        spec = engine.method_spec("savic", **{**QUAD_KW, "beta1": momentum},
                                  pc_kind="identity", local_steps=h_m)
        lr = QUAD_KW["gamma"]
    else:
        spec = engine.method_spec("fedavg", **QUAD_KW, local_steps=h_m)
        lr = QUAD_KW["eta_l"]
    (nb, _), = quad_batches(1, 4)
    batch = quad_torch_batch(nb)
    state = quad_port_state(spec)
    new, met = engine.build_round_step(quad_losses()[1], spec)(state, batch)
    xs, ms, last = [], [], []
    for m in range(4):
        x, mo = torch.zeros(24), torch.zeros(24)
        for h in range(h_m[m]):
            loss, g = _grad(x, {"z": batch["z"][m, h]})
            mo = momentum * mo + g
            x = x - lr * mo
        xs.append(x)
        ms.append(mo)
        last.append(loss)
    np.testing.assert_allclose(new["params"]["x"][0].numpy(),
                               torch.stack(xs).mean(0).numpy(), rtol=1e-6,
                               atol=1e-7)
    if momentum:
        np.testing.assert_allclose(new["mom"]["x"][0].numpy(),
                                   torch.stack(ms).mean(0).numpy(),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(met["loss_per_client"].numpy(), last,
                               rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
def test_uniform_truncated_hm_equals_truncated_batch(fused):
    """H_m = (2,)·M on a batch of H = 5 is bitwise the plain round on the
    batch cut to its first 2 microbatches."""
    spec_m = _specs("fedavg", fused, local_steps=(2,) * 4)[1]
    spec_u = _specs("fedavg", fused)[1]
    (nb, _), = quad_batches(1, 5)
    batch = quad_torch_batch(nb)
    tloss = quad_losses()[1]
    out_m, _ = engine.build_round_step(tloss, spec_m)(
        quad_port_state(spec_m), batch)
    out_u, _ = engine.build_round_step(tloss, spec_u)(
        quad_port_state(spec_u),
        {k: v[:, :2].contiguous() for k, v in batch.items()})
    _port_states_equal(out_m, out_u)


def _oracle_buffered(batches, h_m, lr, B, weighting, poly_a=0.5):
    """Python FIFO oracle of the staleness-buffered averaging server under
    heterogeneous H_m (fedavg clients), in fp64."""
    x = torch.zeros(24, dtype=torch.float64)
    buf = [torch.zeros(24, dtype=torch.float64) for _ in range(B)]
    for t, batch in enumerate(batches):
        xs = []
        for m in range(4):
            xm = x.clone()
            for h in range(h_m[m]):
                xm = xm - lr * _grad(xm.float(), {"z": batch["z"][m, h]}
                                     )[1].double()
            xs.append(xm)
        buf = [torch.stack(xs).mean(0) - x] + buf[:-1]
        ages = np.arange(B, dtype=np.float64)
        s = np.ones(B) if weighting == "constant" else (1 + ages) ** -poly_a
        w = s * (ages <= t)
        w = w / w.sum()
        x = x + sum(float(wi) * bi for wi, bi in zip(w, buf))
    return x


@pytest.mark.parametrize("weighting", ["constant", "polynomial"])
def test_async_buffer_matches_python_oracle(weighting):
    """Six buffered rounds (B = 3, H_m = (1, 3, 2, 3)) equal the FIFO oracle,
    including the early rounds that renormalize over the filled slots."""
    h_m, B = (1, 3, 2, 3), 3
    spec = engine.method_spec(
        "fedavg", **QUAD_KW, local_steps=h_m,
        asynchrony=engine.AsyncSpec(buffer_rounds=B, weighting=weighting))
    state, mets = quad_run_port(spec, rounds=6, H=3)
    batches = [quad_torch_batch(nb) for nb, _ in quad_batches(6, 3)]
    want = _oracle_buffered(batches, h_m, QUAD_KW["eta_l"], B, weighting)
    np.testing.assert_allclose(state["params"]["x"][0].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(mets[-1]["staleness"]) > 0.0


def test_async_b1_reduces_to_plain_averaging():
    """A depth-1 FIFO holds only the fresh delta: the synchronous round to
    fp32 tolerance (x_t + (x̄ − x_t) is not bitwise x̄), staleness 0."""
    st_b, mets = quad_run_port(_specs("fedavg", async_buffer=1)[1])
    st_s, _ = quad_run_port(_specs("fedavg")[1])
    assert tuple(st_b["buffer"]["x"].shape) == (1, 24)
    np.testing.assert_allclose(st_b["params"]["x"].numpy(),
                               st_s["params"]["x"].numpy(), rtol=1e-5,
                               atol=1e-7)
    assert float(mets[-1]["staleness"]) == 0.0


# --------------------------------------------------------------------------- #
# staleness weights
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("weighting", engine.STALENESS_WEIGHTINGS)
def test_staleness_weights_match_reference(weighting):
    """Every (B, round, poly_a, b_eff): the reference's weights to fp32
    rounding, summing to 1, zero past the filled prefix and at ages >=
    b_eff; the polynomial weighting decays with age."""
    for B in (1, 2, 3, 6, 8):
        for r in (0, 1, B - 1, B + 3, 50):
            for a in (0.1, 0.5, 3.0):
                for b_eff in (None, 1, max(1, B // 2)):
                    jw = np.asarray(jeng.staleness_weights(
                        jeng.AsyncSpec(buffer_rounds=B, weighting=weighting,
                                       poly_a=a), jnp.int32(r),
                        None if b_eff is None else jnp.int32(b_eff)))
                    w = engine.staleness_weights(
                        engine.AsyncSpec(buffer_rounds=B, weighting=weighting,
                                         poly_a=a),
                        torch.tensor(r, dtype=torch.int32), b_eff).numpy()
                    assert w.shape == (B,) and w.dtype == np.float32
                    np.testing.assert_allclose(w, jw, rtol=1e-6, atol=0)
                    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
                    assert (w >= 0).all()
                    assert (w[min(r, B - 1) + 1:] == 0).all()
                    if b_eff is not None:
                        assert (w[b_eff:] == 0).all()
    np.testing.assert_array_equal(engine.staleness_weights(
        engine.AsyncSpec(buffer_rounds=1), 0).numpy(), [1.0])
    w = engine.staleness_weights(engine.AsyncSpec(
        buffer_rounds=4, weighting="polynomial"), 10).numpy()
    assert (np.diff(w) < 0).all()


# --------------------------------------------------------------------------- #
# systems-heterogeneity models (data/federated.py), byte for byte
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("model,kw", [
    ("uniform", {}), ("lognormal", {}), ("lognormal", dict(sigma=0.8)),
    ("tiers", {}), ("tiers", dict(tiers=(1.0, 3.0), tier_probs=(0.3, 0.7))),
])
def test_systems_models_match_reference(model, kw):
    """Step times, budgeted H_m and simulated round times equal the
    reference's for every seed and client count tried; the fastest client
    runs the whole budget, everyone at least 1 step."""
    for seed in range(12):
        for M in (2, 4, 16):
            t = fed.sample_step_times(model, M, seed=seed, **kw)
            jt = jfed.sample_step_times(model, M, seed=seed, **kw)
            assert t.tobytes() == jt.tobytes()
            for h_max in (1, 4, 8):
                h = fed.sample_local_steps(model, M, h_max, seed=seed, **kw)
                jh = jfed.sample_local_steps(model, M, h_max, seed=seed, **kw)
                assert h.dtype == jh.dtype and h.tobytes() == jh.tobytes()
                assert h.min() >= 1 and h.max() == h_max
                for barrier, B in (("sync", 0), ("async", 3)):
                    assert fed.simulated_round_time(
                        t, h, barrier=barrier, buffer_rounds=B) == \
                        jfed.simulated_round_time(t, h, barrier=barrier,
                                                  buffer_rounds=B)
    np.testing.assert_array_equal(fed.local_steps_from_times(
        np.array([1.0, 2.0, 4.0, 100.0]), 8), [8, 4, 2, 1])
    np.testing.assert_array_equal(fed.local_steps_from_times(
        np.array([1.0, 3.0]), 6, time_budget=3.0), [3, 1])
    with pytest.raises(ValueError):
        fed.sample_step_times("gaussian", 4)
    with pytest.raises(ValueError):
        fed.simulated_round_time(np.ones(2), [1, 1], barrier="maybe")


# --------------------------------------------------------------------------- #
# validation and round-time shape errors
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bad", [
    lambda: engine.AsyncSpec(buffer_rounds=-1),
    lambda: engine.AsyncSpec(buffer_rounds=1.5),
    lambda: engine.AsyncSpec(weighting="exponential"),
    lambda: engine.AsyncSpec(poly_a=0.0),
    lambda: engine.ClientLoopSpec(local_steps=(2, 0, 1)),
    lambda: engine.ClientLoopSpec(local_steps=()),
    lambda: engine.SyncSpec(asynchrony="fedbuff"),
])
def test_spec_validation(bad):
    with pytest.raises(ValueError):
        bad()


def test_valid_specs_normalize_and_hash():
    s = engine.ClientLoopSpec(local_steps=np.array([2, 3], np.int64))
    assert s.local_steps == (2, 3)
    hash(engine.method_spec("fedavg", local_steps=(1, 2), async_buffer=2))


@pytest.mark.parametrize("hm,match", [((1, 2), "entries for"),
                                      ((3, 3, 3, 9), "exceeds")])
def test_round_time_shape_errors(hm, match):
    spec = engine.method_spec("fedavg", **QUAD_KW, local_steps=hm)
    (nb, _), = quad_batches(1, 3)
    with pytest.raises(ValueError, match=match):
        engine.build_round_step(quad_losses()[1], spec)(
            quad_port_state(spec), quad_torch_batch(nb))


# --------------------------------------------------------------------------- #
# clip + weight decay + H_m on reduced qwen2-0.5b, against the tree path
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
def test_clip_wd_hm_matches_reference_tree_path(fused):
    """Local rmsprop scaling with grad clip 0.5, weight decay 0.01 and
    H_m = (1, 2) on reduced qwen2-0.5b, two rounds, against the reference's
    TREE path (its fused path is not bitwise with it for this composition)
    at 1e-3 (the reference's CPU vdot in the clip)."""
    kw = dict(scaling="local", grad_clip=0.5, weight_decay=0.01,
              local_steps=(1, 2))
    init, want, wmets = run_jax(jsavic.engine_spec(
        JPrecond(kind="rmsprop", clip="add", alpha=1e-2),
        jsavic.SavicConfig(gamma=3e-3, **kw)))
    got, gmets = run_port(savic.engine_spec(
        PrecondConfig(kind="rmsprop", clip="add", alpha=1e-2),
        savic.SavicConfig(gamma=3e-3, use_fused_kernel=fused, **kw)), init)
    assert_state_close(got, want, tol=1e-3)
    for g, w in zip(gmets, wmets):
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(g["loss_per_client"].numpy(),
                                   np.asarray(w["loss_per_client"]),
                                   rtol=1e-3)
    np.testing.assert_array_equal(got["precond"]["t"].numpy(), [2, 4])
