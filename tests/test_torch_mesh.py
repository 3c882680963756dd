"""The port's mesh layer against the reference: the partitioner, the
parameter shape trees, ``ShardFlatLayout``, and the engine's round on CPU
gloo meshes.

In-process: ``params_pspecs`` spec for spec against the reference's under
``paper``, ``paper_fsdp`` and ``plain`` on the reference's fake 16×16 mesh,
every arch at full size (the port's shapes from ``configs.param_shapes``,
the reference's from ``jax.eval_shape``); ``batch_pspecs``,
``serve_batch_pspecs`` and ``cache_pspecs`` on the same shape trees;
``to_placements``' three rules; ``ShardFlatLayout``'s boundary cases and its
mesh-free reference ops equal to the reference's exactly.

Multi-process: one spawn of 4 gloo ranks for the whole file
(``tests/_torch_mesh_worker.py engine``, cases in
``tests/_torch_mesh_cases.py``), under a hard timeout. Each engine case is
held three ways:

* the mesh round against the port's single-device round (on one thread, as
  each rank runs): every state leaf
  to 1e-5 of its largest magnitude (rtol 1e-5), the metrics to rtol 1e-5
  (drift 1e-4, step norm 1e-3: differences of nearly equal params). The
  mesh sums in another order: the sync's all-reduce, the shards' norms,
  the mean of the batch ranks' gradients (paper_fsdp and plain split the
  microbatch over the batch axes);
* the mesh round against the reference's single-device round at the same
  tolerances; the int8 case, where floor(v + u) may flip a quantum on
  deltas that differ in their last bits, at the reference sharding
  worker's (params rtol 2e-3, atol 2e-4; metrics rtol 1e-3, inside its
  loss 5e-3);
* on the same mesh, the fused loop against the tree loop: bitwise.

The feature cases (compression on plans that split the leaves, the
controller, client objectives on plans that split the microbatch) are also
held to their own contracts (``test_mesh_features_hold_their_contracts``);
their compression error, a sum of squares of round deltas, is held as the
drift is (rtol 1e-4), and their int8 runs are held at the int8 tolerances
against the port's single-device round too (a split microbatch's gradient
is a mean over the batch ranks, so a quantum may flip there as well).

The one-device cases are the reference's ``test_one_device_shard_plan_bitwise``
on a 1×1 mesh: bitwise against the port's unsharded fused and tree loops.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_mesh_cases as C
from _hypothesis_compat import given, settings, st
from repro.configs import get_config as jget_config
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.sharding import partitioner as jpart
from repro.utils.flatten import FlatLayout as JFlatLayout
from repro.utils.flatten import ShardFlatLayout as JShardFlatLayout
from repro_torch.configs import get_config, list_archs, param_shapes
from repro_torch.models import build
from repro_torch.sharding import (PartitionSpec, batch_pspecs,
                                  cache_pspecs, params_pspecs, plan_for,
                                  serve_batch_pspecs, to_placements)
from repro_torch.sharding.partitioner import P as TP
from repro_torch.utils.flatten import FlatLayout, ShardFlatLayout
from repro_torch.utils.tree import tree_paths

ARCHS = sorted(list_archs()) + ["qwen3-4b-swa"]
MODES = ("paper", "paper_fsdp", "plain")


class _FakeMesh:
    """Just enough of a mesh for the partitioners' divisibility checks."""

    def __init__(self, shape):
        self.shape = shape


FAKE = _FakeMesh({"data": 16, "model": 16})


def _entries(spec):
    """A spec (either package's) as a tuple of tuples of axis names."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (tuple(e) if isinstance(e, (tuple,
                                                                    list))
                                         else (e,)))
    return tuple(out)


def _jax_spec_paths(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), _entries(s)) for path, s in flat]


def _port_spec_paths(specs):
    return [(p, _entries(s)) for p, s in tree_paths(specs)]


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    return jax.eval_shape(jbuild(jget_config(arch), JCall()).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return param_shapes(get_config(arch))


# --------------------------------------------------------------------------- #
# shapes and specs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference(arch):
    """Paths, shapes and dtypes of the full-size tree, allocation-free."""
    want = [(p, tuple(x.shape), str(x.dtype))
            for p, x in _jax_paths(_jax_shapes(arch))]
    got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tree_paths(_port_shapes(arch))]
    assert got == want
    assert all(x.device.type == "meta"
               for _, x in tree_paths(_port_shapes(arch)))


def _jax_paths(tree):
    from repro.utils.tree import tree_paths as jtree_paths
    return jtree_paths(tree)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_pspecs_equal_the_reference(arch, mode):
    """Spec for spec on the fake 16×16 mesh, without and with the client
    dim (M = 16)."""
    jplan, plan = jpart.plan_for(mode, False), plan_for(mode, False)
    jshape, tshape = _jax_shapes(arch), _port_shapes(arch)
    jcfg, cfg = jget_config(arch), get_config(arch)
    want = _jax_spec_paths(jpart.params_pspecs(jcfg, jshape, FAKE, jplan,
                                               client_dim=False))
    got = _port_spec_paths(params_pspecs(cfg, tshape, FAKE, plan,
                                         client_dim=False))
    assert got == want
    jm = jax.tree.map(lambda s: jax.ShapeDtypeStruct((16,) + s.shape,
                                                     s.dtype), jshape)
    tm = {k: v for k, v in _lead(tshape).items()}
    want = _jax_spec_paths(jpart.params_pspecs(jcfg, jm, FAKE, jplan,
                                               client_dim=True))
    got = _port_spec_paths(params_pspecs(cfg, tm, FAKE, plan,
                                         client_dim=True))
    assert got == want


def _lead(tree, n=16):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                          dtype=t.dtype, device="meta"), tree)


# the reference's own three checks (tests/test_sharding.py), on the port

@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "qwen2-moe-a2.7b"])
def test_param_specs_divisible(arch):
    specs = params_pspecs(get_config(arch), _port_shapes(arch), FAKE,
                          plan_for("paper", False), client_dim=False)
    leaves = dict(tree_paths(_port_shapes(arch)))
    for path, spec in tree_paths(specs):
        for dim, ax in zip(leaves[path].shape, tuple(spec)):
            if ax is not None:
                assert dim % int(np.prod([FAKE.shape[a] for a in ax])) == 0
    assert any("model" in str(s) for _, s in tree_paths(specs))


def test_expert_dim_sharded_when_divisible():
    specs = params_pspecs(get_config("deepseek-v2-236b"),
                          _port_shapes("deepseek-v2-236b"), FAKE,
                          plan_for("paper", False), client_dim=False)
    s = specs["blocks"]["stack"]["ffn"]["experts"]["wg"]
    assert tuple(s)[1] in ("model", ("model",))   # (L,E,d,f): E experts


def test_client_dim_added():
    specs = params_pspecs(get_config("qwen2-0.5b"),
                          _lead(_port_shapes("qwen2-0.5b")), FAKE,
                          plan_for("paper", False), client_dim=True)
    assert all(tuple(s)[0] in ("data", ("data",))
               for _, s in tree_paths(specs))


def _as_jax(tree):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), np.float32 if t.is_floating_point() else np.int32),
        tree)


SMALL = _FakeMesh({"data": 2, "model": 2})
SMALL3 = _FakeMesh({"pod": 2, "data": 1, "model": 2})


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-236b",
                                  "zamba2-2.7b", "internvl2-1b"])
def test_batch_serve_cache_pspecs_equal_the_reference(arch):
    """On reduced archs, the same shape trees through both packages: the
    round batch (M, H, b, ...), a serving batch of 4 and of 1 (not
    divisible: replicated), and the decode cache of 4 and of 1 (sequence
    sharded) on the port's cache layout."""
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, True)
    from repro_torch.launch.steps import _struct
    for mesh, multi in ((SMALL, False), (SMALL3, True)):
        for mode in ("paper", "paper_fsdp", "plain") + (
                ("diloco",) if multi else ()):
            plan, jplan = plan_for(mode, multi), jpart.plan_for(mode, multi)
            rb = _struct(cfg, 4, 32, lead=(2, 3))
            assert _port_spec_paths(batch_pspecs(rb, mesh, plan, True)) == \
                _jax_spec_paths(jpart.batch_pspecs(_as_jax(rb), mesh, jplan,
                                                   True))
            for B in (4, 1):
                sb = _struct(cfg, B, 32)
                assert _port_spec_paths(serve_batch_pspecs(sb, mesh, plan)) \
                    == _jax_spec_paths(jpart.serve_batch_pspecs(
                        _as_jax(sb), mesh, jplan))
                cache = build(cfg).init_cache(B, 64, torch.device("meta"))
                assert _port_spec_paths(cache_pspecs(cfg, cache, mesh,
                                                     plan)) == \
                    _jax_spec_paths(jpart.cache_pspecs(jcfg, _as_jax(cache),
                                                       mesh, jplan))


def _mesh(names, shape):
    """A stand-in for a DeviceMesh: names and the rank array's shape."""
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=torch.zeros(shape))


def test_to_placements_rules():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh(("pod", "data", "model"), (2, 2, 4))
    # a joint entry is Shard(d) on each of its mesh dims, major first
    assert to_placements(mesh, TP(("pod", "data"), "model"), (8, 16)) == \
        (Shard(0), Shard(0), Shard(1))
    # an entry out of mesh order cannot be laid out by nesting
    with pytest.raises(ValueError, match="mesh order"):
        to_placements(mesh, TP(("data", "pod")), (8,))
    # uneven: replicated, never DTensor's uneven Shard
    assert to_placements(mesh, TP("model", ("pod", "data")), (6, 4)) == \
        (Shard(1), Shard(1), Replicate())
    assert to_placements(mesh, TP(), (3,)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="twice"):
        to_placements(mesh, TP("model", "model"), (4, 4))


def test_partition_spec_is_a_tree_leaf():
    spec = PartitionSpec(("data",), None)
    assert tuple(spec) == (("data",), None) and len(spec) == 2
    assert spec == PartitionSpec(("data",), None) == (("data",), None)
    assert tree_paths({"a": spec}) == [("a", spec)]


# --------------------------------------------------------------------------- #
# ShardFlatLayout (the reference's boundary cases)
# --------------------------------------------------------------------------- #


MESH_SHAPE = {"model": 4, "data": 2}


def _rand_tree(shapes, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + s).astype(np.float32)
            for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _both(np_tree, jspecs, tspecs, axes, batch_dims=0, mesh=MESH_SHAPE):
    """Both packages' layouts of one tree, their flatten_ref buffers and
    describe() dicts; the buffers and the dicts must be equal exactly."""
    lead = batch_dims
    one = {k: v[(0,) * lead] for k, v in np_tree.items()}
    jl = JShardFlatLayout.for_tree(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), one),
        jspecs, mesh, axes)
    tl = ShardFlatLayout.for_tree(_t(one), tspecs, mesh, axes)
    assert tl.describe() == jl.describe()
    jbuf = np.asarray(jl.flatten_ref(np_tree, batch_dims=batch_dims))
    tbuf = tl.flatten_ref(_t(np_tree), batch_dims=batch_dims)
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    back = tl.unflatten_ref(tbuf, batch_dims=batch_dims)
    jback = jl.unflatten_ref(jbuf, batch_dims=batch_dims)
    for k in np_tree:
        np.testing.assert_array_equal(back[k].numpy(), np_tree[k])
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
    return tl


@pytest.mark.parametrize("dim,split", [(12, True), (13, False), (15, False)])
def test_uneven_leaf_splits(dim, split):
    tl = _both(_rand_tree({"w": (dim,)}), {"w": JP("model")},
               {"w": TP("model")}, ("model",))
    leaf = tl.describe()["leaves"][0]
    assert leaf["split"] == split and leaf["uneven_fallback"] == (not split)
    assert tl.n_local == (dim // 4 if split else dim)
    assert tl.n_flat == 4 * tl.n_local


def test_leaf_smaller_than_one_shard():
    tl = _both(_rand_tree({"w": (12,), "tiny": (2,)}),
               {"w": JP("model"), "tiny": JP("model")},
               {"w": TP("model"), "tiny": TP("model")}, ("model",))
    desc = {l["path"]: l for l in tl.describe()["leaves"]}
    assert desc["tiny"]["uneven_fallback"] and not desc["tiny"]["split"]
    assert tl.n_local == 12 // 4 + 2


def test_multi_axis_entry_and_dim1_split():
    tree = _rand_tree({"a": (3, 16), "b": (16, 5)}, lead=(2,))
    tl = _both(tree, {"a": JP(None, ("data", "model")), "b": JP("model", None)},
               {"a": TP(None, ("data", "model")), "b": TP("model", None)},
               ("data", "model"), batch_dims=1)
    desc = {l["path"]: l for l in tl.describe()["leaves"]}
    assert desc["a"]["local_shape"] == [3, 2]
    assert desc["b"]["local_shape"] == [4, 5]
    assert tl.n_shards == 8
    assert tl.flat_spec((None,)) == TP(None, ("data", "model"))
    assert tl.leaf_specs((None,)) == {"a": TP(None, None, ("data", "model")),
                                      "b": TP(None, "model", None)}
    # a rank's flatten is the FlatLayout of its blocks; shard 5's block is
    # the slice [5·n_local, 6·n_local) of the reference buffer
    buf = tl.flatten_ref(_t(tree), batch_dims=1)
    sl = tl._shard_slices(5)
    mine = {k: _t(tree)[k][(slice(None),) + s] for k, s in zip(("a", "b"), sl)}
    n = tl.n_local
    assert torch.equal(tl.flatten(mine, batch_dims=1), buf[:, 5 * n:6 * n])
    back = tl.unflatten(buf[:, 5 * n:6 * n], batch_dims=1)
    assert all(torch.equal(back[k], mine[k]) for k in mine)


def test_single_shard_degenerates_to_flat_layout():
    tree = _rand_tree({"w": (7, 3), "b": (5,)})
    tl = _both(tree, {"w": JP(None, "model"), "b": JP()},
               {"w": TP(None, "model"), "b": TP()}, ("model",),
               mesh={"model": 1})
    flat = FlatLayout.for_tree(_t(tree))
    assert tl.n_shards == 1 and tl.n_flat == flat.n_total
    assert torch.equal(tl.flatten_ref(_t(tree)), flat.flatten(_t(tree)))
    assert tl.describe()["n_flat"] == JFlatLayout.for_tree(tree).n_total


def test_alien_axis_rejected():
    with pytest.raises(ValueError, match="outside the shard axes"):
        ShardFlatLayout.for_tree(_t(_rand_tree({"w": (8,)})),
                                 {"w": TP("data")}, MESH_SHAPE, ("model",))


def test_spec_leaf_count_mismatch_rejected():
    with pytest.raises(ValueError, match="leaves"):
        ShardFlatLayout.for_tree(_t(_rand_tree({"w": (8,), "b": (3,)})),
                                 {"w": TP("model")}, MESH_SHAPE, ("model",))


def _round_trip(dims, shards, seed):
    shapes = {f"l{i}": (d,) for i, (d, _) in enumerate(dims)}
    jspecs = {f"l{i}": (JP("model") if want else JP())
              for i, (_, want) in enumerate(dims)}
    tspecs = {f"l{i}": (TP("model") if want else TP())
              for i, (_, want) in enumerate(dims)}
    tl = _both(_rand_tree(shapes, seed=seed), jspecs, tspecs, ("model",),
               mesh={"model": shards})
    assert tl.n_flat == shards * tl.n_local


@given(st.lists(st.tuples(st.integers(1, 24), st.booleans()), min_size=1,
                max_size=5),
       st.integers(min_value=1, max_value=4), st.integers(0, 99))
@settings(max_examples=25, deadline=None)
def test_shard_flat_round_trip_property(dims, shards, seed):
    _round_trip(dims, shards, seed)


@pytest.mark.parametrize("seed", range(6))
def test_shard_flat_round_trip_sweep(seed):
    """The property above on seeded draws (hypothesis may be absent)."""
    rng = np.random.default_rng(seed)
    dims = [(int(rng.integers(1, 25)), bool(rng.integers(0, 2)))
            for _ in range(int(rng.integers(1, 6)))]
    _round_trip(dims, int(rng.integers(1, 5)), seed)


# --------------------------------------------------------------------------- #
# the engine on 4 gloo ranks
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return C.run_worker("engine", tmp_path_factory.mktemp("mesh_engine"),
                        timeout=300)


@functools.lru_cache(maxsize=None)
def _single(case_id, fused):
    with C.one_thread():
        return C.run_port(_case(case_id), fused)


@functools.lru_cache(maxsize=None)
def _reference(case_id):
    return C.run_jax(_case(case_id))


def _case(case_id):
    return next(c for c in C.CASES if c.id == case_id)


@pytest.mark.parametrize("case_id", C.CASE_IDS)
def test_mesh_round_matches_single_device_and_reference(mesh_runs, case_id):
    runs = mesh_runs[case_id]
    (st_t, met_t), (st_f, met_f) = runs[False], runs[True]
    # fused against tree on the same mesh: bitwise
    C.assert_states_close(st_f, st_t, bitwise=True)
    for a, b in zip(met_f, met_t):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    # against the port's single-device round (tree loop); int8's
    # floor(v + u) may flip a quantum where two deltas differ in their last
    # bits: the feature cases' int8 runs (a split microbatch's gradient is
    # a mean over the batch ranks) are held to the reference sharding
    # worker's tolerances
    feature = case_id in C.FEATURE_IDS
    scale = C.FEATURE_SCALE if feature else C.METRIC_SCALE
    st_s, met_s = _single(case_id, False)
    if "int8" in case_id and feature:
        C.assert_states_close(st_t, st_s, rtol=2e-3, atol_scale=0.0,
                              atol=2e-4)
        C.assert_metrics_close(met_t, met_s, rtol=1e-3, scale=scale)
    else:
        C.assert_states_close(st_t, st_s)
        C.assert_metrics_close(met_t, met_s, scale=scale)
    # against the reference's single-device round; int8's floor(v + u) may
    # flip a quantum where the two packages' deltas differ in their last
    # bits: that case is held to the reference sharding worker's tolerances
    st_j, met_j = _reference(case_id)
    if "int8" in case_id:
        C.assert_states_close(st_t, st_j, rtol=2e-3, atol_scale=0.0, atol=2e-4)
        C.assert_metrics_close(met_t, met_j, rtol=1e-3, scale=scale)
    else:
        C.assert_states_close(st_t, st_j)
        C.assert_metrics_close(met_t, met_j, scale=scale)


@pytest.mark.parametrize("method", C.ONE_DEVICE_METHODS)
def test_one_device_shard_plan_bitwise(mesh_runs, method):
    """The shard-plan path on a 1×1 mesh (4 clients on one rank) against the
    unsharded fused and tree loops: bitwise."""
    st_s, loss_s = mesh_runs["one-device-" + method]
    for fused in (True, False):
        st_b, loss_b = C.quad_run(method, fused)
        for k in ("params", "mom"):
            np.testing.assert_array_equal(st_s[k]["x"], st_b[k]["x"])
        if "d" in st_b["precond"]:
            np.testing.assert_array_equal(st_s["precond"]["d"]["x"],
                                          st_b["precond"]["d"]["x"])
        assert loss_s == loss_b


@pytest.mark.parametrize("case_id", C.FEATURE_IDS)
def test_mesh_features_hold_their_contracts(mesh_runs, case_id):
    """The mesh features beyond the tolerances above: every rank's top-k /
    rand-k block is ``_compress_leaf`` on the run's own gathered deltas bit
    for bit, with kc entries kept a row (checked in the ranks, counted
    here); the measured payload is the single-device rounds' exactly; the
    controller's knobs are the single-device rounds' and the numpy
    oracle's replay of the mesh run's own observations, a client sat out a
    round (H_m = 0) and the budget grew."""
    import _reference_controller as ref_ctrl
    case = _case(case_id)
    runs = mesh_runs[case_id]
    spec = C.port_spec(case, False)
    if spec.sync.compression.op in ("topk", "randk"):
        for fused in (False, True):
            calls, rows = runs["masks", fused]
            assert calls > 0 and rows >= calls
    met_t = runs[False][1]
    for _, met_o in (_single(case_id, False), _reference(case_id)):
        for g, w in zip(met_t, met_o):
            if "wire_bytes" in w:
                np.testing.assert_array_equal(g["wire_bytes"],
                                              np.asarray(w["wire_bytes"]))
            for k in ("ctrl_h_m", "ctrl_h_t", "ctrl_b_eff"):
                if k in w:
                    np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                                  err_msg=k)
    if not spec.controller.enabled:
        return
    ctrl = spec.controller
    s = ref_ctrl.init_ctrl_state(ctrl, case.n_clients)
    for r, met in enumerate(met_t):
        np.testing.assert_array_equal(met["ctrl_h_m"], s["h_m"])
        assert int(met["ctrl_h_t"]) == int(s["h_t"]), r
        np.testing.assert_array_equal(met["ctrl_k"], s["k"])
        s, _ = ref_ctrl.controller_step(ctrl, s, {
            "delta_sq_mean": met["delta_sq_mean"],
            "delta_sq_avg": met["delta_sq_avg"],
            "payload_sq": met["payload_sq"],
            "resid_sq": met["compression_err"]})
        np.testing.assert_array_max_ulp(met["ctrl_gns_ema"], s["gns_ema"],
                                        maxulp=1)
    assert 0 in met_t[0]["ctrl_h_m"].tolist()
    assert int(met_t[-1]["ctrl_h_t"]) > ctrl.h_min


def test_model_hooks_run_at_the_reference_points():
    """``act_shard`` on the residual input of ``loss``; ``moe_shard`` on each
    MoE layer's dispatch buffer, its experts' output and the combined
    output (the reference's three constraint points). Hooks that return
    their input leave the loss bit for bit as without them."""
    from repro_torch.models import ModelCallConfig
    from repro_torch.utils import rng
    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    seen = []
    hooked = ModelCallConfig(
        dtype=torch.float32, remat=False,
        act_shard=lambda x: seen.append(("act", tuple(x.shape))) or x,
        moe_shard=lambda x, where: seen.append((where, x.dim())) or x)
    plain = ModelCallConfig(dtype=torch.float32, remat=False)
    params = build(cfg, plain).init(torch.Generator().manual_seed(0))
    toks = rng.TorchStream(0).randint((2, 16), 0, cfg.vocab_size, "cpu")
    batch = {"tokens": toks, "labels": toks}
    want = build(cfg, plain).loss(params, batch)
    got = build(cfg, hooked).loss(params, batch)
    assert torch.equal(got, want)
    n_moe = cfg.n_layers - cfg.moe.moe_layer_start
    assert seen[0] == ("act", (2, 16, cfg.d_model))
    assert seen[1:] == [("dispatch", 4), ("combine", 4), ("combine", 3)] * n_moe


def test_meshes_need_their_ranks():
    """Importing the mesh module starts no process group; a mesh larger
    than the world raises, as the reference's does."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 4 ranks, have 0"):
        mesh.make_debug_mesh((2, 2), device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh.make_production_mesh(device_type="cpu")

