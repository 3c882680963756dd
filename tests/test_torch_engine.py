"""The port's round engine held against the live reference engine: all six
methods, global and local scaling, tree and fused client loops, over 2
rounds of reduced qwen2-0.5b from the same starting state (carried across by
``repro_torch.bridge``) on byte-identical round batches.

The reference side runs its tree path (``use_fused_kernel=False``), which its
own tests pin bitwise to its fused path for these compositions; one case
also runs the reference's fused path (Pallas in interpret mode). Clip + weight
decay is held against the reference's tree path only (its fused path is not
bitwise there, see ROADMAP queue 3).

Tolerances (fp32; the two backends' matmuls add in different orders, so
gradients differ in the last bits and the optimizer carries that forward):
  * params, momentum, D, server v: 1e-5 of the largest magnitude in the same
    state entry (a leaf whose true gradient is 0, such as the key bias, holds
    only rounding noise, so its own magnitude is no scale);
  * server m: 1e-5 of the matching params leaf's largest magnitude — m is
    built from Δ = x' − x, which cancels to ulps of x;
  * loss 1e-5 relative; client drift 1e-4 relative (a sum of squares of
    differences of nearly equal params); the adaptive server's step norm
    1e-3 relative (it scales m, and so Δ's cancellation, by 1/(√v + τ));
  * sync in bf16: 1e-2 of the entry scale (the frameworks reduce bf16 with
    different accumulators); grad clip: 1e-3 (see its case below).
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (M, assert_metrics_close, assert_state_close,
                           batches, models, quad_losses, run_jax, run_port)
from _torch_rng_replay import JaxStream
from repro.core import controller as jctrl
from repro.core import engine as jeng
from repro.core import objectives as jobj
from repro.core import fedopt as jfedopt
from repro.core import savic as jsavic
from repro.core.preconditioner import PrecondConfig as JPrecond
from repro.data import LMRoundLoader as JLoader
from repro.data import TokenStream as JStream
from repro.utils.flatten import FlatLayout as JFlatLayout
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.core import engine, fedopt, objectives, savic
from repro_torch.core.preconditioner import PrecondConfig
from repro_torch.data import LMRoundLoader, TokenStream
from repro_torch.utils.flatten import FlatLayout
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

KW = dict(gamma=3e-3, eta_l=3e-3)

# name -> method_spec kwargs (scaling only matters for non-identity D)
CONFIGS = {
    "savic-global": dict(method="savic", scaling="global"),
    "savic-local": dict(method="savic", scaling="local"),
    "fedavg": dict(method="fedavg"),
    "fedadagrad": dict(method="fedadagrad"),
    "fedadam": dict(method="fedadam"),
    "fedyogi": dict(method="fedyogi"),
    "local-adam": dict(method="local-adam"),
}


@functools.lru_cache(maxsize=None)
def _jax_method(name, fused=False, **extra):
    kw = dict(CONFIGS[name])
    return run_jax(jeng.method_spec(kw.pop("method"), use_fused_kernel=fused,
                                    **KW, **kw, **extra))


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_method_matches_reference(name, fused):
    init, want, wmets = _jax_method(name)
    kw = dict(CONFIGS[name])
    spec = engine.method_spec(kw.pop("method"), use_fused_kernel=fused,
                              **KW, **kw)
    got, gmets = run_port(spec, init)
    assert_state_close(got, want)
    assert_metrics_close(gmets, wmets)


@pytest.mark.parametrize("name", ["local-adam"])
def test_fused_matches_reference_fused_path(name):
    """Port fused loop (plain version on the CPU) == reference fused loop
    (Pallas kernel in interpret mode), on the case that runs K1 with a D
    update and the debias schedule."""
    init, want, wmets = _jax_method(name, fused=True)
    kw = dict(CONFIGS[name])
    spec = engine.method_spec(kw.pop("method"), use_fused_kernel=True,
                              **KW, **kw)
    got, gmets = run_port(spec, init)
    assert_state_close(got, want)
    assert_metrics_close(gmets, wmets)


COMPOSITIONS = {
    # local scaling with grad clip + weight decay, rule-2 const schedule
    # (tolerance 1e-3: the reference's CPU ``jnp.vdot`` sums the 229k squares
    # of the embedding grad sequentially in fp32 and is off by ~1e-4
    # relative against fp64 — torch's sum is not — and the clip scale carries
    # that into every gradient)
    "clip-wd-local": dict(savic=dict(scaling="local", grad_clip=0.5,
                                     weight_decay=0.01),
                          pc=dict(kind="rmsprop", clip="add"), tol=1e-3),
    # global D from the average of per-client stats, AdaGrad
    "avg-local-adagrad": dict(savic=dict(stat_source="avg_local"),
                              pc=dict(kind="adagrad")),
    # heavy-ball identity savic with a bf16 sync average
    "bf16-sync": dict(savic=dict(sync_dtype="bfloat16"),
                      pc=dict(kind="adam"), tol=1e-2),
}


@functools.lru_cache(maxsize=None)
def _jax_composition(name):
    c = COMPOSITIONS[name]
    return run_jax(jsavic.engine_spec(
        JPrecond(alpha=1e-2, **c["pc"]),
        jsavic.SavicConfig(gamma=3e-3, **c["savic"])))


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_composition_matches_reference_tree_path(name, fused):
    c = COMPOSITIONS[name]
    init, want, wmets = _jax_composition(name)
    spec = savic.engine_spec(PrecondConfig(alpha=1e-2, **c["pc"]),
                             savic.SavicConfig(gamma=3e-3,
                                               use_fused_kernel=fused,
                                               **c["savic"]))
    got, gmets = run_port(spec, init)
    tol = c.get("tol", 1e-5)
    assert_state_close(got, want, tol=tol)
    assert_metrics_close(gmets, wmets, tol=tol)


def test_fedopt_preset_matches_reference():
    """core/fedopt.py's single-replica adapter (FedYogi, client momentum)."""
    _, jm, tm = models()
    jcfg = jfedopt.FedOptConfig(server_opt="yogi", eta_l=3e-3,
                                client_momentum=0.5)
    cfg = fedopt.FedOptConfig(server_opt="yogi", eta_l=3e-3,
                              client_momentum=0.5)
    jst = jfedopt.init_state(jax.random.PRNGKey(0), jm.init, jcfg)
    st = state_from_jax(jax.device_get(jst), "cpu")
    jstep = jax.jit(jfedopt.build_round_step(jm.loss, jcfg))
    step = fedopt.build_round_step(tm.loss, cfg)
    for r, nb in enumerate(batches()):
        jst, jmet = jstep(jst, jax.tree.map(jnp.asarray, nb),
                          jax.random.PRNGKey(r))
        st, met = step(st, {k: torch.from_numpy(v).long()
                            for k, v in nb.items()},
                       JaxStream(jax.random.PRNGKey(r)))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    want = jax.device_get(jst)
    for k, w in jtree_paths(want["params"]):
        np.testing.assert_allclose(dict(tree_paths(st["params"]))[k].numpy(),
                                   np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


def test_fedopt_preset_passes_compression_and_participation():
    """core/fedopt.py hands participation and compression to the engine and,
    on the fused path, runs int8 on K3 (as method_spec sets it); its
    single-replica state has no EF slot, so EF is refused."""
    comp = engine.CompressionSpec(op="int8-stochastic")
    cfg = fedopt.FedOptConfig(eta_l=3e-3, participation=0.5,
                              compression=comp, use_fused_kernel=True)
    spec = fedopt.engine_spec(cfg)
    assert spec == engine.method_spec(
        "fedadam", eta_l=3e-3, participation=0.5, use_fused_kernel=True,
        compression=dataclasses.replace(comp, use_fused_kernel=True))
    _, _, tm = models()
    st = fedopt.init_state(torch.Generator().manual_seed(0), tm.init, cfg)
    step = fedopt.build_round_step(tm.loss, cfg)
    st, met = step(st, {k: torch.from_numpy(v).long()
                        for k, v in batches()[0].items()},
                   JaxStream(jax.random.PRNGKey(0)))
    assert np.isfinite(float(met["loss"])) and float(met["step_norm"]) > 0
    with pytest.raises(ValueError, match="EF"):
        fedopt.engine_spec(fedopt.FedOptConfig(compression=dataclasses.replace(
            comp, error_feedback=True)))


def test_round_batches_byte_identical():
    for seed, (Mc, Hc, b, s) in [(0, (2, 2, 1, 8)), (3, (4, 2, 8, 128))]:
        jl = JLoader(JStream(512, seed=seed), Mc, b)
        tl = LMRoundLoader(TokenStream(512, seed=seed), Mc, b)
        for r in (0, 1, 7):
            jb, tb = jl.round_batch(r, Hc, s), tl.round_batch(r, Hc, s)
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                assert jb[k].tobytes() == tb[k].tobytes()


def test_flat_layout_matches_reference():
    _, jm, _ = models()
    jp = jax.device_get(jeng.init_state(jax.random.PRNGKey(0), jm.init,
                                        jeng.method_spec("savic"),
                                        M)["params"])
    tp = params_from_jax(jp, "cpu")
    jl = JFlatLayout.for_tree(jp, batch_dims=1)
    tl = FlatLayout.for_tree(tp, batch_dims=1)
    assert (tl.paths, tl.shapes, tl.offsets, tl.n_total) == \
        (jl.paths, jl.shapes, jl.offsets, jl.n_total)
    flat = tl.flatten(tp, batch_dims=1)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jl.flatten(jax.tree.map(jnp.asarray, jp),
                                            batch_dims=1)))
    back = tl.unflatten(flat, batch_dims=1)
    for (k, a), (_, b) in zip(tree_paths(back), tree_paths(tp)):
        assert torch.equal(a, b), k
        assert a.data_ptr() >= flat.data_ptr()      # a view, not a copy
    flat[0, 0] = 123.0
    assert float(tree_paths(back)[0][1].reshape(M, -1)[0, 0]) == 123.0


# the knobs this port once refused at build time
UNPORTED = {
    "async": dict(async_buffer=2),
    "local_steps": dict(local_steps=(1, 2)),
    "controller": dict(controller=engine.ControllerSpec(enabled=True,
                                                        h_max=2)),
    "personal": dict(personal=("final_norm",), scaling="local"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_features_raise_at_build(name):
    """Each knob the port once refused now builds and runs a round on
    reduced qwen2-0.5b: nothing is refused as unported any more."""
    _, _, tm = models()
    spec = engine.method_spec("savic", **KW, **UNPORTED[name])
    gen = torch.Generator().manual_seed(0)
    state = engine.init_state(gen, tm.init, spec, M)
    _, met = engine.build_round_step(tm.loss, spec)(
        state, {k: torch.from_numpy(v).long()
                for k, v in batches()[0].items()},
        JaxStream(jax.random.PRNGKey(0)))
    assert np.isfinite(float(met["loss"]))


def test_objective_raises_at_build():
    """A client objective builds (the objectives are ported); only what the
    reference refuses at build time raises, with a ValueError."""
    _, _, tm = models()
    obj = objectives.lm_objective(objectives.ObjectiveSpec(
        kind="pseudo-label"), tm)
    engine.build_round_step(tm.loss, engine.method_spec("savic"),
                            objective=obj)
    with pytest.raises(ValueError, match="personal"):
        engine.build_round_step(tm.loss, engine.method_spec(
            "savic", personal=("final_norm",)), objective=obj)


@pytest.mark.parametrize("bad", [
    lambda: engine.SyncSpec(participation=0.0),
    lambda: engine.SyncSpec(sync_dtype="notadtype"),
    lambda: engine.SyncSpec(personal="final_norm"),
    lambda: engine.ClientLoopSpec(scaling="both"),
    lambda: engine.ClientLoopSpec(local_steps=(0,)),
    lambda: engine.CompressionSpec(op="zip"),
    lambda: engine.AsyncSpec(buffer_rounds=-1),
    lambda: engine.ServerSpec(kind="adaptive", opt="sgd"),
    lambda: engine.ServerSpec(sync_k=0.5),
    lambda: engine.method_spec("sgd"),
    lambda: engine.method_spec("savic", server_sync_k=0.5),
])
def test_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        bad()


def test_fused_path_raises_on_non_fp32_state():
    """The fused round step raises on client state that is not fp32: the
    route to the tree loop is taken at build time (``fused_route``)."""
    _, jm, tm = models()
    spec = engine.method_spec("savic", use_fused_kernel=True, **KW)
    init = jax.device_get(jeng.init_state(jax.random.PRNGKey(0), jm.init,
                                          jeng.method_spec("savic"), M))
    state = state_from_jax(init, "cpu")
    state["mom"] = {k: v for k, v in state["mom"].items()}
    state["mom"]["final_norm"] = {"scale": state["mom"]["final_norm"][
        "scale"].to(torch.bfloat16)}
    step = engine.build_round_step(tm.loss, spec)
    with pytest.raises(NotImplementedError, match="fp32"):
        step(state, {k: torch.from_numpy(v).long()
                     for k, v in batches()[0].items()})


def test_fused_route_takes_tree_loop_on_non_fp32_state():
    """``fused_route`` sends bf16 client state under ``use_fused_kernel`` to
    the tree loop at build time, with the reference's
    ``fused_kernel_fallback`` text, as the reference's fused loop falls back
    (its counterpart:
    ``tests/test_fused_step.py::test_non_fp32_state_falls_back_to_tree_path``).
    Two rounds from bf16 momentum give the tree loop's state bit for bit;
    fp32 state keeps the fused loop."""
    _, jm, tm = models()
    init = jax.device_get(jeng.init_state(jax.random.PRNGKey(0), jm.init,
                                          jeng.method_spec("savic"), M))
    nb = batches()
    fused_spec = engine.method_spec("savic", use_fused_kernel=True, **KW)
    assert engine.fused_route(fused_spec, state_from_jax(init, "cpu")) \
        == (fused_spec, "")
    out = {}
    for fused in (False, True):
        state = state_from_jax(init, "cpu")
        state["mom"] = {k: v for k, v in state["mom"].items()}
        state["mom"]["final_norm"] = {"scale": state["mom"]["final_norm"][
            "scale"].to(torch.bfloat16)}
        spec, why = engine.fused_route(engine.method_spec(
            "savic", use_fused_kernel=fused, **KW), state)
        assert not spec.client.use_fused_kernel
        assert why == ("non-fp32 client state (mom; flat view is fp32 by "
                       "contract)" if fused else "")
        step = engine.build_round_step(tm.loss, spec)
        for r in range(2):
            state, _ = step(state, {k: torch.from_numpy(v).long()
                                    for k, v in nb[r].items()})
        out[fused] = state
    tree, fused = tree_paths(out[False]), tree_paths(out[True])
    assert [p for p, _ in tree] == [p for p, _ in fused]
    for (path, a), (_, b) in zip(tree, fused):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_state_is_not_written_in_place():
    """Rounds return new state; the caller's state keeps its values (the
    fused kernel writes only into the round's own flat buffers)."""
    _, _, tm = models()
    init, _, _ = _jax_method("local-adam")
    state = state_from_jax(init, "cpu")
    before = {k: v.clone() for k, v in tree_paths(state)}
    spec = engine.method_spec("local-adam", use_fused_kernel=True, **KW)
    engine.build_round_step(tm.loss, spec)(
        state, {k: torch.from_numpy(v).long()
                for k, v in batches()[0].items()})
    for k, v in tree_paths(state):
        assert torch.equal(v, before[k]), k


def test_savic_preset_module_matches_engine():
    spec = savic.engine_spec(PrecondConfig(kind="adam", alpha=1e-2),
                             savic.SavicConfig(gamma=3e-3))
    assert spec == engine.method_spec("savic", gamma=3e-3)
    assert dataclasses.asdict(spec.client) == dataclasses.asdict(
        engine.ClientLoopSpec(lr=3e-3, momentum=0.9))


# --------------------------------------------------------------------------- #
# The round's random parts: participation and the Hutchinson kinds, on the
# reference's draws replayed through the port's rng interface
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_clients,part", [(2, 0.5), (4, 0.5), (5, 0.5),
                                            (8, 0.3), (6, 1.0)])
def test_participation_weights_match_reference(n_clients, part):
    """The sampled subset and its weights are the reference's, exactly."""
    jspec, spec = jeng.SyncSpec(participation=part), \
        engine.SyncSpec(participation=part)
    for r in range(4):
        key = jax.random.PRNGKey(r)
        want = np.asarray(jeng.participation_weights(jspec, key, n_clients))
        got = engine.participation_weights(spec, JaxStream(key), n_clients,
                                           "cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert float(got.sum()) == pytest.approx(1.0)


def test_random_parts_need_a_stream():
    _, _, tm = models()
    init, _, _ = _jax_method("savic-global")
    spec = engine.method_spec("savic", participation=0.5, **KW)
    with pytest.raises(ValueError, match="stream"):
        engine.build_round_step(tm.loss, spec)(
            state_from_jax(init, "cpu"),
            {k: torch.from_numpy(v).long() for k, v in batches()[0].items()})


# OASIS (rule 3) and AdaHessian (rule 2, debias) with local D, and with global
# D from both stat sources; partial participation. Tolerance: the HVP is
# reverse-over-reverse here and forward-over-reverse in the reference, so
# the Hutchinson stats agree to fp32 rounding only; 1e-5 of the entry scale
# as for the other rounds.
RANDOMIZED = {
    "oasis-global": dict(savic=dict(), pc=dict(kind="oasis")),
    "oasis-global-avg-local": dict(savic=dict(stat_source="avg_local"),
                                   pc=dict(kind="oasis")),
    "oasis-local": dict(savic=dict(scaling="local"), pc=dict(kind="oasis")),
    "adahessian-global": dict(savic=dict(), pc=dict(kind="adahessian")),
    "adahessian-global-avg-local": dict(savic=dict(stat_source="avg_local"),
                                        pc=dict(kind="adahessian")),
    "adahessian-local": dict(savic=dict(scaling="local"),
                             pc=dict(kind="adahessian")),
    "oasis-participation": dict(savic=dict(participation=0.5),
                                pc=dict(kind="oasis")),
    "adam-participation": dict(savic=dict(participation=0.5),
                               pc=dict(kind="adam")),
}


@functools.lru_cache(maxsize=None)
def _jax_randomized(name):
    c = RANDOMIZED[name]
    return run_jax(jsavic.engine_spec(
        JPrecond(alpha=1e-2, **c["pc"]),
        jsavic.SavicConfig(gamma=3e-3, **c["savic"])))


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("name", list(RANDOMIZED))
def test_randomized_round_matches_reference(name, fused):
    c = RANDOMIZED[name]
    init, want, wmets = _jax_randomized(name)
    spec = savic.engine_spec(PrecondConfig(alpha=1e-2, **c["pc"]),
                             savic.SavicConfig(gamma=3e-3,
                                               use_fused_kernel=fused,
                                               **c["savic"]))
    got, gmets = run_port(spec, init)
    assert_state_close(got, want)
    assert_metrics_close(gmets, wmets)


@pytest.mark.parametrize("method,kw", [
    ("savic", {}), ("savic", dict(scaling="local")), ("fedavg", {}),
    ("fedadam", dict(compression="topk", compression_k=0.5,
                     error_feedback=True)),
], ids=["savic-global", "savic-local", "fedavg", "fedadam-topk-ef"])
def test_every_spec_the_reference_builds_builds(method, kw):
    """Every combination of H_m, the FIFO, the controller, an objective and
    a personal mask: the port builds exactly what the reference builds and
    refuses the rest with a ValueError, as the reference does (nothing is
    refused as unported)."""
    jloss, tloss = quad_losses()
    jobjective = jobj.ClientObjective(jobj.ObjectiveSpec(kind="pseudo-label"),
                                      lambda p, mc, k: jloss(p, mc), jloss)
    tobjective = objectives.ClientObjective(
        objectives.ObjectiveSpec(kind="pseudo-label"),
        lambda p, mc, s: tloss(p, mc), tloss)
    ctrls = [None, dict(enabled=True, h_max=2),
             dict(enabled=True, h_max=2, buffer_max=2)]
    seen = set()
    for hm, buf, c, obj, pers in itertools.product(
            [None, (1, 2, 2, 1)], [0, 2], ctrls, [False, True],
            [(), ("x",)]):
        knobs = dict(kw, local_steps=hm, async_buffer=buf, personal=pers)
        outcome = []
        for eng, ctrl_mod, loss, o in (
                (jeng, jctrl, jloss, jobjective),
                (engine, engine, tloss, tobjective)):
            spec = eng.method_spec(method, controller=(
                ctrl_mod.ControllerSpec(**c) if c else None), **knobs)
            try:
                eng.build_round_step(loss, spec,
                                     objective=o if obj else None)
                outcome.append("built")
            except ValueError as e:
                outcome.append(str(e).split(":")[0])
        assert outcome[0] == outcome[1], (knobs, c, obj, outcome)
        seen.add(outcome[0] == "built")
    assert seen == {True, False}
