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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import engine as jeng
from repro.core import fedopt as jfedopt
from repro.core import savic as jsavic
from repro.core.preconditioner import PrecondConfig as JPrecond
from repro.data import LMRoundLoader as JLoader
from repro.data import TokenStream as JStream
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.utils.flatten import FlatLayout as JFlatLayout
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine, fedopt, savic
from repro_torch.core.preconditioner import PrecondConfig
from repro_torch.data import LMRoundLoader, TokenStream
from repro_torch.models import ModelCallConfig, build
from repro_torch.utils.flatten import FlatLayout
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
M, H, B, S, ROUNDS = 2, 2, 1, 8, 2
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
def _models():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                            reduced=True)
    # remat off on both sides: it changes nothing numerically (pinned in
    # test_torch_models.py) and halves the reference's compile time
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, remat=False))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=False))
    return jcfg, jm, tm


def _batches():
    jcfg, _, _ = _models()
    loader = JLoader(JStream(jcfg.vocab_size, seed=0), M, B)
    return [loader.round_batch(r, H, S) for r in range(ROUNDS)]


def _run_jax(jspec):
    _, jm, _ = _models()
    state = jeng.init_state(jax.random.PRNGKey(0), jm.init, jspec, M)
    init = jax.device_get(state)
    step = jax.jit(jeng.build_round_step(jm.loss, jspec))
    mets = []
    for r, nb in enumerate(_batches()):
        state, met = step(state, jax.tree.map(jnp.asarray, nb),
                          jax.random.PRNGKey(r))
        mets.append(jax.device_get(met))
    return init, jax.device_get(state), mets


@functools.lru_cache(maxsize=None)
def _jax_method(name, fused=False, **extra):
    kw = dict(CONFIGS[name])
    return _run_jax(jeng.method_spec(kw.pop("method"), use_fused_kernel=fused,
                                     **KW, **kw, **extra))


def _run_port(spec, init):
    _, _, tm = _models()
    state = state_from_jax(init, "cpu")
    step = engine.build_round_step(tm.loss, spec)
    mets = []
    for nb in _batches():
        state, met = step(state, {k: torch.from_numpy(v).long()
                                  for k, v in nb.items()})
        mets.append(met)
    return state, mets


def _entry(path):
    """The state entry a leaf belongs to: params, mom, precond/d, server/m,
    server/v."""
    head = path.split("/")
    return "/".join(head[:2]) if head[0] in ("precond", "server") \
        else head[0]


def _assert_state_close(got, want, tol=1e-5):
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
        if k.startswith("server/m/"):
            sc = np.abs(np.asarray(wd["params/" + k[len("server/m/"):]])
                        ).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * sc, err_msg=k)


def _assert_metrics_close(got, want, tol=1e-5):
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


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_method_matches_reference(name, fused):
    init, want, wmets = _jax_method(name)
    kw = dict(CONFIGS[name])
    spec = engine.method_spec(kw.pop("method"), use_fused_kernel=fused,
                              **KW, **kw)
    got, gmets = _run_port(spec, init)
    _assert_state_close(got, want)
    _assert_metrics_close(gmets, wmets)


@pytest.mark.parametrize("name", ["local-adam"])
def test_fused_matches_reference_fused_path(name):
    """Port fused loop (plain version on the CPU) == reference fused loop
    (Pallas kernel in interpret mode), on the case that runs K1 with a D
    update and the debias schedule."""
    init, want, wmets = _jax_method(name, fused=True)
    kw = dict(CONFIGS[name])
    spec = engine.method_spec(kw.pop("method"), use_fused_kernel=True,
                              **KW, **kw)
    got, gmets = _run_port(spec, init)
    _assert_state_close(got, want)
    _assert_metrics_close(gmets, wmets)


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
    return _run_jax(jsavic.engine_spec(
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
    got, gmets = _run_port(spec, init)
    tol = c.get("tol", 1e-5)
    _assert_state_close(got, want, tol=tol)
    _assert_metrics_close(gmets, wmets, tol=tol)


def test_fedopt_preset_matches_reference():
    """core/fedopt.py's single-replica adapter (FedYogi, client momentum)."""
    _, jm, tm = _models()
    jcfg = jfedopt.FedOptConfig(server_opt="yogi", eta_l=3e-3,
                                client_momentum=0.5)
    cfg = fedopt.FedOptConfig(server_opt="yogi", eta_l=3e-3,
                              client_momentum=0.5)
    jst = jfedopt.init_state(jax.random.PRNGKey(0), jm.init, jcfg)
    st = state_from_jax(jax.device_get(jst), "cpu")
    jstep = jax.jit(jfedopt.build_round_step(jm.loss, jcfg))
    step = fedopt.build_round_step(tm.loss, cfg)
    for r, nb in enumerate(_batches()):
        jst, jmet = jstep(jst, jax.tree.map(jnp.asarray, nb),
                          jax.random.PRNGKey(r))
        st, met = step(st, {k: torch.from_numpy(v).long()
                            for k, v in nb.items()})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    want = jax.device_get(jst)
    for k, w in jtree_paths(want["params"]):
        np.testing.assert_allclose(dict(tree_paths(st["params"]))[k].numpy(),
                                   np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


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
    _, jm, _ = _models()
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


UNPORTED = {
    "compression": dict(compression="topk", compression_k=0.5),
    "async": dict(async_buffer=2),
    "local_steps": dict(local_steps=(1, 2)),
    "controller": dict(controller=object()),
    "personal": dict(personal=("final_norm",), scaling="local"),
    "participation": dict(participation=0.5),
    "hutchinson": dict(pc_kind="oasis"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_features_raise_at_build(name):
    _, _, tm = _models()
    spec = engine.method_spec("savic", **UNPORTED[name])
    with pytest.raises(NotImplementedError, match="not ported"):
        engine.build_round_step(tm.loss, spec)


def test_objective_and_server_compression_raise_at_build():
    _, _, tm = _models()
    with pytest.raises(NotImplementedError, match="objectives"):
        engine.build_round_step(tm.loss, engine.method_spec("savic"),
                                objective=object())
    spec = engine.method_spec("fedadam", server_sync_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="server m/v"):
        engine.build_round_step(tm.loss, spec)


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
    """The reference quietly falls back to its tree path; the port raises."""
    _, jm, tm = _models()
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
                     for k, v in _batches()[0].items()})


def test_state_is_not_written_in_place():
    """Rounds return new state; the caller's state keeps its values (the
    fused kernel writes only into the round's own flat buffers)."""
    _, _, tm = _models()
    init, _, _ = _jax_method("local-adam")
    state = state_from_jax(init, "cpu")
    before = {k: v.clone() for k, v in tree_paths(state)}
    spec = engine.method_spec("local-adam", use_fused_kernel=True, **KW)
    engine.build_round_step(tm.loss, spec)(
        state, {k: torch.from_numpy(v).long()
                for k, v in _batches()[0].items()})
    for k, v in tree_paths(state):
        assert torch.equal(v, before[k]), k


def test_savic_preset_module_matches_engine():
    spec = savic.engine_spec(PrecondConfig(kind="adam", alpha=1e-2),
                             savic.SavicConfig(gamma=3e-3))
    assert spec == engine.method_spec("savic", gamma=3e-3)
    assert dataclasses.asdict(spec.client) == dataclasses.asdict(
        engine.ClientLoopSpec(lr=3e-3, momentum=0.9))
