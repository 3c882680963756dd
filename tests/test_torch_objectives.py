"""Client objectives and personalization in the port
(``repro_torch.core.objectives``, ``SyncSpec.personal``), held against the
reference (``repro.core.objectives``, ``repro.core.engine``,
``repro.data``): the port's counterpart of tests/test_objectives.py.

Rounds run the Section-5 quadratic on both packages (``_torch_parity``),
with the objective's noise replayed through ``JaxStream``; the LM objectives
run reduced qwen2-0.5b. Tolerances: state 1e-5 of its entry's scale,
metrics 1e-5 relative, objective values 1e-5 relative and gradients 1e-4 of
each leaf's largest magnitude (fp32 backward passes in two orders; the
consistency term's gradient is a difference of nearly equal softmaxes);
labeled masks, loaders and wire bytes exact; the identity contracts bitwise
within the port. The reference's checkpoint round trip of a stripped state
waits for the port's checkpoint; its mesh launch tests wait for the mesh.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (QUAD_KW, assert_quad_metrics, assert_state_close,
                           models, quad_batches, quad_losses,
                           quad_port_state, quad_run_jax, quad_run_port,
                           quad_torch_batch)
from _torch_rng_replay import JaxStream
from repro.core import engine as jeng
from repro.core import objectives as jobj
from repro.data import (ClassificationData, FederatedLoader as JFedLoader,
                        LMRoundLoader as JLMLoader, TokenStream as JStream,
                        labeled_mask as jlabeled_mask, main_class_partition)
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax
from repro_torch.core import engine, objectives
from repro_torch.data import (FederatedLoader, LMRoundLoader, TokenStream,
                              labeled_mask)
from repro_torch.utils.rng import TorchStream
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)


def _quad_objectives(noise=0.3):
    """(reference, port) ClientObjectives on the quadratic whose loss is
    scaled by (1 + noise·N(0, 1)) from the objective stream, so a round
    consumes the objective draws."""
    jbase, tbase = quad_losses()

    def jloss(params, micro, key):
        return jbase(params, micro) * (1.0 + noise * jax.random.normal(
            key, ()))

    def tloss(params, micro, stream):
        return tbase(params, micro) * (1.0 + noise * stream.normal(
            (), "cpu"))

    return (jobj.ClientObjective(spec=jobj.ObjectiveSpec(kind="consistency"),
                                 loss=jloss, base_loss=jbase),
            objectives.ClientObjective(
                spec=objectives.ObjectiveSpec(kind="consistency"),
                loss=tloss, base_loss=tbase))


def _equal_states(a, b):
    for (k, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), k


# --------------------------------------------------------------------------- #
# identity and the engine's keyed gradient call
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", engine.METHODS)
def test_supervised_objective_is_the_plain_round(method):
    """objective=None, an explicit supervised ClientObjective and
    personal=() run the plain round, bitwise."""
    spec = engine.method_spec(method, **QUAD_KW)
    assert spec.sync.personal == ()
    tbase = quad_losses()[1]
    ident = objectives.ClientObjective(
        spec=objectives.ObjectiveSpec(), loss=lambda p, mc, s: tbase(p, mc),
        base_loss=tbase)
    a, ma = quad_run_port(spec)
    b, mb = quad_run_port(spec, objective=ident)
    _equal_states(a, b)
    assert torch.equal(ma[-1]["loss"], mb[-1]["loss"])


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("method", ["savic", "local-adam", "fedadam"])
def test_objective_round_matches_reference(method, fused):
    """A keyed objective: the port's rounds draw the reference's objective
    noise (step stream folded by 11) and land on its state."""
    jo, to = _quad_objectives()
    jspec = jeng.method_spec(method, **QUAD_KW)
    spec = engine.method_spec(method, **QUAD_KW, use_fused_kernel=fused)
    init, want, wmets = quad_run_jax(jspec, objective=jo)
    got, gmets = quad_run_port(spec, init, objective=to)
    assert_state_close(got, want)
    assert_quad_metrics(gmets, wmets)


def test_objective_changes_the_trajectory_and_fused_equals_tree():
    """The noise reaches the trajectory, and the fused loop takes the same
    keyed gradients as the tree loop, bitwise."""
    _, to = _quad_objectives()
    mk = lambda fused: engine.method_spec("savic", **QUAD_KW,
                                          use_fused_kernel=fused)
    plain, _ = quad_run_port(mk(False))
    tree, _ = quad_run_port(mk(False), objective=to)
    fused, _ = quad_run_port(mk(True), objective=to)
    assert not torch.equal(plain["params"]["x"], tree["params"]["x"])
    assert torch.equal(tree["params"]["x"], fused["params"]["x"])


def test_objective_needs_a_stream():
    _, to = _quad_objectives()
    spec = engine.method_spec("savic", **QUAD_KW)
    (nb, _), = quad_batches(1, 2)
    with pytest.raises(ValueError, match="stream"):
        engine.build_round_step(to.base_loss, spec, objective=to)(
            quad_port_state(spec), quad_torch_batch(nb))


# --------------------------------------------------------------------------- #
# objective math on classification microbatches
# --------------------------------------------------------------------------- #


def _toy(labeled=None, b=8, d=4, c=3, scale=1.0):
    rng = np.random.default_rng(1)
    w = (scale * rng.standard_normal((d, c))).astype(np.float32)
    micro = {"x": rng.standard_normal((b, d)).astype(np.float32),
             "y": rng.integers(0, c, b).astype(np.int32)}
    if labeled is not None:
        micro["labeled"] = np.asarray(labeled, np.float32)
    return w, micro


def _both(kind, w, micro, **kw):
    """The objective's value on both packages (keyed by PRNGKey(2))."""
    jo = jobj.classification_objective(jobj.ObjectiveSpec(kind=kind, **kw),
                                       lambda p, x: x @ p["w"])
    to = objectives.classification_objective(
        objectives.ObjectiveSpec(kind=kind, **kw), lambda p, x: x @ p["w"])
    key = jax.random.PRNGKey(2)
    jv = float(jo.loss({"w": jnp.asarray(w)},
                       {k: jnp.asarray(v) for k, v in micro.items()}, key))
    tv = float(to.loss({"w": torch.from_numpy(w)},
                       {k: torch.from_numpy(v) for k, v in micro.items()},
                       JaxStream(key)))
    return jv, tv


def _sup(w, micro, mask=None):
    y = torch.from_numpy(micro["y"])
    mask = torch.from_numpy(micro["labeled"]) if mask is None else mask
    return float(objectives._masked_ce(torch.from_numpy(micro["x"] @ w), y,
                                       mask))


@pytest.mark.parametrize("kind,kw,labeled,vs_sup", [
    ("consistency", dict(noise_sigma=0.0, unlabeled_weight=5.0),
     [1, 1, 0, 0, 1, 0, 0, 0], "equal"),
    ("consistency", dict(noise_sigma=0.5, unlabeled_weight=5.0),
     [1, 1, 0, 0, 1, 0, 0, 0], "above"),
    ("pseudo-label", dict(pseudo_threshold=1 - 1e-6, unlabeled_weight=2.0),
     [1, 0, 0, 0, 1, 0, 0, 0], "equal"),
    ("pseudo-label", dict(pseudo_threshold=1e-6, unlabeled_weight=2.0),
     [1, 0, 0, 0, 1, 0, 0, 0], "above"),
    ("pseudo-label", dict(unlabeled_weight=3.0), None, "equal"),
], ids=["consistency-sigma0", "consistency-noise", "pseudo-closed",
        "pseudo-open", "pseudo-fully-labeled"])
def test_classification_objective_matches_reference(kind, kw, labeled,
                                                    vs_sup):
    """Each objective's value equals the reference's on the same inputs and
    key; σ = 0 and a shut gate collapse to the labeled-subset CE, noise and
    an open gate add to it, and a batch without a 'labeled' leaf counts as
    fully labeled."""
    w, micro = _toy(labeled, scale=3.0 if kind == "pseudo-label" else 1.0)
    jv, tv = _both(kind, w, micro, **kw)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    sup = _sup(w, micro, None if labeled is not None else torch.ones(8))
    if vs_sup == "equal":
        np.testing.assert_allclose(tv, sup, rtol=1e-6)
    else:
        assert tv > sup


def test_masked_ce_empty_mask_is_zero():
    logits = torch.tensor([[2.0, -1.0], [0.5, 0.5]])
    y = torch.tensor([0, 1])
    assert float(objectives._masked_ce(logits, y, torch.zeros(2))) == 0.0
    full = float(objectives._masked_ce(logits, y, torch.ones(2)))
    np.testing.assert_allclose(full, float(jobj._masked_ce(
        jnp.asarray(logits.numpy()), jnp.asarray(y.numpy()), jnp.ones(2))),
        rtol=1e-6)


def test_objective_spec_validation():
    for bad in (dict(kind="nope"), dict(unlabeled_weight=-1.0),
                dict(pseudo_threshold=1.5), dict(noise_sigma=-0.1)):
        with pytest.raises(ValueError):
            objectives.ObjectiveSpec(**bad)
    with pytest.raises(ValueError):
        objectives.build_objective(objectives.ObjectiveSpec(
            kind="consistency"))
    assert objectives.build_objective(None) is None
    assert objectives.build_objective(objectives.ObjectiveSpec()) is None


# --------------------------------------------------------------------------- #
# the LM objectives on reduced qwen2-0.5b
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _lm_inputs():
    jcfg, jm, _ = models()
    b = JLMLoader(JStream(jcfg.vocab_size, seed=0), 1, 4, labeled_frac=0.5,
                  seed=3).round_batch(0, 1, 8)
    micro = {k: v[0, 0] for k, v in b.items()}
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return params, micro


@pytest.mark.parametrize("kind,kw", [
    # at a random init the predictions are near uniform over the 2048 padded
    # logits: a large weight and a low gate make the unlabeled term count
    ("consistency", dict(noise_sigma=0.5, unlabeled_weight=1e4)),
    ("pseudo-label", dict(pseudo_threshold=1e-4)),
], ids=["consistency", "pseudo-label"])
def test_lm_objective_matches_reference(kind, kw):
    """Value and gradient of the LM objective on a half-labeled microbatch,
    the token-dropout draws replayed (bernoulli as uniform < p, int32
    randint)."""
    _, jm, tm = models()
    params, micro = _lm_inputs()
    assert 0 < micro["labeled"].sum() < 4
    jo = jobj.lm_objective(jobj.ObjectiveSpec(kind=kind, **kw), jm)
    to = objectives.lm_objective(objectives.ObjectiveSpec(kind=kind, **kw),
                                 tm)
    key = jax.random.PRNGKey(5)
    jv, jg = jax.value_and_grad(jo.loss)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in micro.items()}, key)
    tmicro = {k: torch.from_numpy(v).to(torch.float32 if k == "labeled"
                                        else torch.long)
              for k, v in micro.items()}
    tv, tg = engine.value_and_grad(to.loss)(params_from_jax(params, "cpu"),
                                            tmicro, JaxStream(key))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    got = dict(tree_paths(tg))
    for k, w in jtree_paths(jax.device_get(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)
    # the unlabeled term engages: more than the labeled-subset CE
    sup = float(to.base_loss(params_from_jax(params, "cpu"), {
        "tokens": tmicro["tokens"], "labels": torch.where(
            tmicro["labeled"][:, None] > 0, tmicro["labels"], -1)}))
    assert float(tv) > sup


# --------------------------------------------------------------------------- #
# strip / merge
# --------------------------------------------------------------------------- #


def test_strip_personal_identity_for_empty_mask():
    tree = {"a": torch.ones(3), "b": {"head": torch.zeros(2)}}
    assert engine.strip_personal((), tree) is tree


def test_strip_personal_substring_match_and_merge():
    tree = {"blocks": {"w": torch.ones(2)}, "head": {"w": torch.full((2,),
                                                                     7.0)},
            "final_norm": torch.full((3,), 5.0)}
    stripped = engine.strip_personal(("head", "final_norm"), tree)
    assert stripped["head"]["w"] is None and stripped["final_norm"] is None
    assert torch.equal(stripped["blocks"]["w"], torch.ones(2))
    assert [k for k, _ in tree_paths(stripped)] == ["blocks/w"]
    jstripped = jeng.strip_personal(("head", "final_norm"), jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tree))
    assert [k for k, _ in jtree_paths(jstripped)] == ["blocks/w"]
    merged = engine._merge_personal(stripped, tree, lambda s, f: s * 0.0)
    assert torch.equal(merged["blocks"]["w"], torch.zeros(2))
    assert torch.equal(merged["head"]["w"], torch.full((2,), 7.0))
    assert torch.equal(merged["final_norm"], torch.full((3,), 5.0))
    assert merged["final_norm"] is not tree["final_norm"]   # a copy


@pytest.mark.parametrize("bad", [("ok", ""), "head"])
def test_sync_spec_personal_validation(bad):
    with pytest.raises(ValueError):
        engine.SyncSpec(personal=bad)


# --------------------------------------------------------------------------- #
# personalization: personal leaves never cross the wire
# --------------------------------------------------------------------------- #

POISON = (np.arange(4, dtype=np.float32) * 100.0 + 1.0)[:, None] \
    * np.ones((1, 3), np.float32)


def _poison(state):
    state["params"]["head"] = jnp.asarray(POISON)


def _head_init(v=0.0):
    return lambda key: {"x": jnp.zeros(24), "head": jnp.full((3,), v)}


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("method", ["savic", "fedavg", "fedadam",
                                    "local-adam"])
def test_personal_leaf_never_mixes_and_matches_reference(method, fused):
    """Per-client poison in a zero-gradient personal leaf stays exactly
    where each client put it through three rounds, the synced leaf is one
    value across clients, server/EF/FIFO state carries no personal leaf,
    and the state matches the reference's."""
    kw = dict(personal=("head",), async_buffer=2, compression="topk",
              compression_k=0.5, error_feedback=True)
    if method in ("savic", "local-adam"):
        kw["scaling"] = "local"          # a global non-identity D refuses
    jspec = jeng.method_spec(method, **QUAD_KW, **kw)
    spec = engine.method_spec(method, **QUAD_KW, use_fused_kernel=fused,
                              **kw)
    init, want, wmets = quad_run_jax(jspec, rounds=3, init=_head_init(),
                                     edit=_poison)
    got, gmets = quad_run_port(spec, init, rounds=3)
    np.testing.assert_array_equal(got["params"]["head"].numpy(), POISON)
    x = got["params"]["x"]
    assert torch.equal(x, x[:1].expand_as(x))
    for key in ("server", "ef", "buffer"):
        if key in got:
            assert all("head" not in k for k, _ in tree_paths(got[key]))
    assert_state_close(got, want)
    assert_quad_metrics(gmets, wmets)


def test_personal_matches_no_personal_on_synced_leaves():
    """With a zero-gradient personal leaf, the synced leaves' trajectory is
    bitwise the one-leaf run's."""
    spec_p = engine.method_spec("fedadam", **QUAD_KW, personal=("head",))
    spec_0 = engine.method_spec("fedadam", **QUAD_KW)
    st_p, _ = quad_run_port(spec_p, jax.device_get(jeng.init_state(
        jax.random.PRNGKey(0), _head_init(3.0), jeng.method_spec(
            "fedadam", personal=("head",)), 4)))
    st_0, _ = quad_run_port(spec_0)
    assert torch.equal(st_p["params"]["x"], st_0["params"]["x"])
    assert torch.equal(st_p["server"]["v"]["x"], st_0["server"]["v"]["x"])


def test_personal_global_precond_rejected():
    spec = engine.method_spec("savic", **QUAD_KW, personal=("head",))
    assert spec.client.scaling == "global" and spec.precond.kind != "identity"
    with pytest.raises(ValueError, match="personal"):
        engine.build_round_step(quad_losses()[1], spec)


@pytest.mark.parametrize("method,kw", [
    ("fedadam", {}), ("savic", dict(scaling="local")),
    ("fedadam", dict(compression="topk", compression_k=0.3,
                     server_sync_k=0.5)),
    ("fedavg", dict(compression="int8-stochastic")),
])
def test_bytes_on_wire_drops_exactly_the_personal_subset(method, kw):
    """Personalization removes exactly the personal leaves' bytes, on every
    leg, and equals the reference's accounting."""
    shapes = {"x": (64,), "head": (16,)}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    jparams = {k: jax.ShapeDtypeStruct(s, jnp.float32)
               for k, s in shapes.items()}
    w_p = engine.bytes_on_wire(engine.method_spec(
        method, personal=("head",), **kw), params)
    w_0 = engine.bytes_on_wire(engine.method_spec(method, **kw), params)
    w_x = engine.bytes_on_wire(engine.method_spec(method, **kw),
                               {"x": params["x"]})
    assert w_p == w_x
    assert w_p == jeng.bytes_on_wire(jeng.method_spec(
        method, personal=("head",), **kw), jparams)
    if not kw:
        assert w_0["total_bytes"] - w_p["total_bytes"] == 16 * 4


# --------------------------------------------------------------------------- #
# loaders and the labeled mask
# --------------------------------------------------------------------------- #


def test_labeled_mask_matches_reference_and_is_stratified():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 10, size=5000)
    for frac in (0.0, 0.05, 0.1, 0.37, 1.0):
        for seed in (0, 1, 7):
            m = labeled_mask(y, frac, seed=seed)
            assert m.tobytes() == jlabeled_mask(y, frac, seed=seed).tobytes()
    m = labeled_mask(y, 0.1, seed=1)
    assert m.dtype == np.float32 and set(np.unique(m)) <= {0.0, 1.0}
    assert abs(int(m.sum()) - 500) <= 10
    for c in range(10):
        sel = m[y == c]
        assert sel.sum() >= 1 and abs(sel.mean() - 0.1) < 0.03


@pytest.mark.filterwarnings("ignore:main_class_partition")
def test_federated_loader_labeled_leaf_matches_reference():
    d = ClassificationData.make(n=2000, n_classes=10)
    parts = main_class_partition(d.y, 4, 0.5)
    lab = jlabeled_mask(d.y, 0.2, seed=3)
    for labeled in (lab, None):
        a = FederatedLoader(d.x, d.y, parts, batch_size=8, labeled=labeled)
        b = JFedLoader(d.x, d.y, parts, batch_size=8, labeled=labeled)
        for _ in range(2):
            ba, bb = a.round_batch(H=3), b.round_batch(H=3)
            assert ba.keys() == bb.keys()
            for k in ba:
                assert ba[k].dtype == bb[k].dtype
                assert ba[k].tobytes() == bb[k].tobytes()
        assert ("labeled" in ba) == (labeled is not None)
    assert ba.keys() == {"x", "y"}


def test_lm_round_loader_labeled_leaf_round_addressable():
    stream = TokenStream(128, seed=0)
    loader = LMRoundLoader(stream, 2, 4, labeled_frac=0.25, seed=7)
    ref = JLMLoader(JStream(128, seed=0), 2, 4, labeled_frac=0.25, seed=7)
    b1, b2 = loader.round_batch(3, 2, 16), loader.round_batch(3, 2, 16)
    assert b1["labeled"].shape == (2, 2, 4)
    assert b1["labeled"].tobytes() == b2["labeled"].tobytes()
    for k, v in ref.round_batch(3, 2, 16).items():
        assert b1[k].tobytes() == v.tobytes()
    assert not np.array_equal(b1["labeled"],
                              loader.round_batch(4, 2, 16)["labeled"])
    assert "labeled" not in LMRoundLoader(stream, 2, 4).round_batch(3, 2, 16)


# --------------------------------------------------------------------------- #
# end to end: a semi-supervised MLP federation learns
# --------------------------------------------------------------------------- #


@pytest.mark.filterwarnings("ignore:main_class_partition")
def test_semi_supervised_federation_learns():
    """Engine × consistency objective × labeled-mask loader: the loss falls
    over 12 rounds of fedadam on a main-class split with 10 % labels."""
    data = ClassificationData.make(n=4000, n_classes=10, seed=0)
    parts = main_class_partition(data.y, 4, 0.3, seed=0)
    loader = FederatedLoader(data.x, data.y.astype(np.int64), parts,
                             batch_size=16, seed=0,
                             labeled=labeled_mask(data.y, 0.1, seed=0))
    n_in = data.x.shape[1]
    gen = torch.Generator().manual_seed(0)

    def init(g):
        return {"w1": torch.randn(n_in, 32, generator=gen) * n_in ** -0.5,
                "b1": torch.zeros(32),
                "w2": torch.randn(32, 10, generator=gen) * 32 ** -0.5,
                "b2": torch.zeros(10)}

    def logits_fn(p, x):
        return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    obj = objectives.classification_objective(objectives.ObjectiveSpec(
        kind="consistency", unlabeled_weight=0.5, noise_sigma=0.1), logits_fn)
    spec = engine.method_spec("fedadam", eta_l=0.02, eta=0.05)
    step = engine.build_round_step(obj.base_loss, spec, objective=obj)
    state = engine.init_state(gen, init, spec, 4)
    root, losses = TorchStream(1), []
    for r in range(12):
        batch = {k: torch.from_numpy(v) for k, v in
                 loader.round_batch(H=4).items()}
        state, met = step(state, batch, root.fold(r))
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0], losses
