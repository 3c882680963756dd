"""The port's dry run (``launch/dryrun.py``), its cost model
(``utils/cost.py``), its H100 terms (``launch/roofline.py``), the
``train_lm`` projection rows, and the two small modules beside them
(``optim/inner.py``, ``examples/serve_batched_torch.py``), held against
the reference and against counts made by hand.

Every dry run here starts a ``fake`` process group of 1 or 4 ranks in this
process and destroys it; the ``no_group_left`` fixture fails a test that
leaves one behind (the files of a pytest worker share its process). Fake
tensors are ``cpu`` tensors in a CPU-only torch (see ``dryrun``'s
docstring).

Tolerances: counts (FLOPs, bytes, collective bytes and counts, launches)
are integers and held exactly; the optimizer steps at 1e-6 relative
(fp32, the same operations in both frameworks); ids exactly.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.core import engine
from repro_torch.launch import dryrun, roofline, steps, train_lm
from repro_torch.utils import cost, rng
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ShapeConfig("tiny_train", 32, 4, "train")
PREFILL = ShapeConfig("tiny_prefill", 64, 4, "prefill")
DECODE = ShapeConfig("tiny_decode", 64, 4, "decode")


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group up"


def _built(mode, fused=False, h_local=2, mesh_shape=(2, 2),
           **kw):
    """``build_train_step`` of reduced qwen2-0.5b on a fake mesh, inside
    the caller's ``fake_world``."""
    mesh = dryrun._mesh(False, mesh_shape, "cpu")
    return steps.build_train_step("qwen2-0.5b", TRAIN, mesh, mode=mode,
                                  reduced=True, h_local=h_local,
                                  use_fused_kernel=fused, **kw)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #

def test_pairs_to_run_match_the_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    pairs = configs.pairs_to_run()
    assert pairs == jconfigs.pairs_to_run()
    assert len(pairs) == 34
    assert {s for a, s in pairs if a == "qwen2-0.5b"} == {
        "train_4k", "prefill_32k", "decode_32k"}


# --------------------------------------------------------------------------- #
# the fused loop's routing by dtype (tests/test_system.py's two cases)
# --------------------------------------------------------------------------- #

def test_dryrun_fused_sharded_artifact_schema(tmp_path):
    """A plan that shards the params keeps ``use_fused_kernel`` and records
    ``flat_layout_sharded`` with the reference's per-shard schema, and no
    ``fused_kernel_fallback``; the dry run's record carries it."""
    with dryrun.fake_world(1):
        built = _built("plain", fused=True, mesh_shape=(1, 1))
    assert built.meta["engine_spec"].client.use_fused_kernel
    assert "fused_kernel_fallback" not in built.meta
    assert "flat_layout" not in built.meta
    lay = built.meta["flat_layout_sharded"]
    assert set(lay) >= {"n_shards", "axes", "axis_sizes", "n_local", "n_flat",
                        "leaves"}
    assert lay["n_flat"] == lay["n_shards"] * lay["n_local"]
    for leaf in lay["leaves"]:
        assert set(leaf) >= {"path", "global_shape", "local_shape", "size",
                             "offset", "split", "uneven_fallback"}
    json.dumps(lay)
    rec = dryrun.run_one("qwen2-0.5b", TRAIN.name, shape=TRAIN, mode="plain",
                         reduced=True, mesh_shape=(1, 1), h_local=2,
                         use_fused_kernel=True, out_dir=str(tmp_path),
                         verbose=False)
    assert rec["flat_layout_sharded"] == lay
    assert rec["custom_counts"] == {"repro_torch.fused_step_flat": 2}


def test_dryrun_fused_fallback_only_for_non_fp32(monkeypatch):
    """``fused_kernel_fallback`` only for non-fp32 client state, with the
    reference's text; the flag is then off and no flat layout is kept."""
    from repro_torch.core import PrecondConfig, SavicConfig, savic
    f32 = {"x": torch.empty(4, device="meta")}
    bf16 = {"x": torch.empty(4, dtype=torch.bfloat16, device="meta")}
    spec = savic.engine_spec(PrecondConfig(kind="adam", alpha=1e-2),
                             SavicConfig(gamma=1e-3, beta1=0.9))
    t = torch.empty((), dtype=torch.int32, device="meta")
    base = {"params": f32, "mom": f32, "precond": {"d": f32, "t": t}}
    assert engine.fused_non_fp32(base, spec) == ""
    assert engine.fused_non_fp32({**base, "mom": bf16}, spec) == "mom"
    assert engine.fused_non_fp32(
        {**base, "precond": {"d": bf16, "t": t}}, spec) == "precond.d"

    orig = steps.engine.init_state

    def bf16_init(gen, init_params_fn, spec, n_clients):
        st = orig(gen, init_params_fn, spec, n_clients)
        for name in ("params", "mom"):
            st[name] = tree_map(lambda x: x.to(torch.bfloat16), st[name])
        return st

    monkeypatch.setattr(steps.engine, "init_state", bf16_init)
    with dryrun.fake_world(1):
        built = _built("plain", fused=True, mesh_shape=(1, 1))
    assert not built.meta["engine_spec"].client.use_fused_kernel
    assert built.meta["fused_kernel_fallback"] == (
        "non-fp32 client state (params; flat view is fp32 by contract)")
    assert "flat_layout_sharded" not in built.meta
    assert "flat_layout" not in built.meta


# --------------------------------------------------------------------------- #
# the cost model (tests/test_hlo_cost.py's counterparts)
# --------------------------------------------------------------------------- #

def _count(fn, *shapes, dtype=torch.float32):
    with FakeTensorMode():
        args = [torch.empty(s, dtype=dtype) for s in shapes]
        mode = cost.CostMode()
        with mode:
            fn(*args)
    return cost.summary(mode.totals())


def test_matmul_flops_are_the_analytic_count():
    assert _count(lambda a, b: a @ b, (64, 128), (128, 32))["flops"] \
        == 2 * 64 * 128 * 32
    r = _count(lambda c, a, b: torch.addmm(c, a, b), (32,), (64, 128),
               (128, 32))
    assert r["flops"] == 2 * 64 * 128 * 32
    r = _count(torch.bmm, (3, 16, 8), (3, 8, 4), dtype=torch.bfloat16)
    assert r["flops_by_dtype"] == {"bfloat16": 3 * 2 * 16 * 8 * 4}
    r = _count(lambda a, b: torch.baddbmm(torch.zeros(3, 16, 4), a, b),
               (3, 16, 8), (3, 8, 4))
    assert r["flops"] == 3 * 2 * 16 * 8 * 4
    # elementwise work is not counted, as hlo_cost counts only dots
    assert _count(lambda a: torch.tanh(a) * 2, (64, 64))["flops"] == 0


def test_bytes_of_elementwise_inplace_and_view_ops():
    # a + b: read both, write the result
    assert _count(torch.add, (256, 64), (256, 64))["bytes_accessed"] \
        == 3 * 256 * 64 * 4
    # an in-place op reads and writes its argument
    assert _count(lambda a: a.mul_(2.0), (100,))["bytes_accessed"] \
        == 2 * 100 * 4
    # views move nothing (the slice, the transpose); the reshape of a
    # transpose is a copy: read and written once
    assert _count(lambda a: a.t().reshape(-1)[:10], (8, 8))[
        "bytes_accessed"] == 2 * 8 * 8 * 4
    assert _count(lambda a: a.t()[:, 2:].unsqueeze(0), (8, 8))[
        "bytes_accessed"] == 0
    # a broadcast operand is read once
    assert _count(lambda a, b: a + b, (32, 16), (16,))["bytes_accessed"] \
        == (32 * 16 + 16 + 32 * 16) * 4
    # out=: written, not read
    assert _count(lambda a, o: torch.add(a, 1.0, out=o), (50,), (50,))[
        "bytes_accessed"] == 2 * 50 * 4
    # a gather reads what it picks and the indices
    with FakeTensorMode():
        table, idx = torch.empty(1000, 16), torch.empty(7, dtype=torch.int64)
        mode = cost.CostMode()
        with mode:
            torch.nn.functional.embedding(idx, table)
    assert cost.summary(mode.totals())["bytes_accessed"] \
        == 2 * 7 * 16 * 4 + 7 * 8


def test_live_bytes_and_peak():
    with FakeTensorMode():
        a = torch.empty(1000)
        mode = cost.CostMode()
        mode.track(a)
        with mode:
            b = a * 2                 # 8000 live
            c = b.view(10, 100)       # a view: no new storage
            del b, c                  # freed: 4000 live
            d = a + 1
    assert mode.peak == 8000 and mode.live == 8000
    del d


def test_collective_operand_bytes_by_kind():
    """Operand bytes per kind with hlo.py's conventions on a fake 2×2 of
    256 ranks' worth of groups: the group read from the op, its bytes on
    the intra-node side when its ranks share a node of 8."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_world(16):
        mesh = dryrun._mesh(False, (2, 8), "cpu")   # data 2 × model 8
        model, data = mesh.get_group("model"), mesh.get_group("data")
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty(64, 4)                  # 1024 B
            mode = cost.CostMode(node_ranks=8)
            with mode:
                dist.all_reduce(x, group=model)      # 1024, intra
                dist.all_reduce(x, group=data)       # 1024, inter
                o = torch.empty(512, 4)
                dist.all_gather_into_tensor(o, x, group=model)   # 1024
                fc.reduce_scatter_tensor(x, "sum", 0, model)     # 1024
                fc.all_to_all_single(x, None, None, model)       # 1024
                dist.broadcast(x, src=0, group=model)            # 1024
                DTensor.from_local(torch.empty(8, 4), mesh,
                                   (Replicate(), Shard(0)),
                                   run_check=False).full_tensor()  # 128
    r = cost.summary(mode.totals())
    assert r["collective_by_kind"] == {
        "all-reduce": 2048, "all-gather": 1024 + 128, "reduce-scatter": 1024,
        "all-to-all": 1024, "broadcast": 1024}
    assert r["collective_counts"] == {
        "all-reduce": 2, "all-gather": 2, "reduce-scatter": 1,
        "all-to-all": 1, "broadcast": 1}
    assert r["collective_inter_bytes"] == 1024
    assert r["collective_intra_bytes"] == r["collective_bytes"] - 1024


# --------------------------------------------------------------------------- #
# trip counts and the round's collectives
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mode,fused", [("paper", False),
                                        ("paper_fsdp", True)])
def test_h_scaled_count_equals_the_whole_round(mode, fused):
    """c(2) + (H − 2)(c(3) − c(2)) equals the count of a traced H = 5
    round: FLOPs, bytes, collectives, the op census and K1's launches."""
    with dryrun.fake_world(4):
        built = _built(mode, fused=fused, h_local=5)
        got, peak, a, _, traced, trips = dryrun._trace_train(built, "cpu")
        stream = rng.TorchStream(0).fold(0)
        want, wpeak, wa, _ = dryrun._trace(
            dryrun._train_inputs(built, 5, "cpu"),
            lambda s, b: built.fn(s, b, stream), True)
    assert (traced, trips) == (5, 5)
    assert got == want
    assert a == wa
    # the (H, M) losses add 4·M_local bytes a step beyond the batch rows
    assert 0 <= wpeak - peak <= 2 * 4
    assert got.get("custom:repro_torch.fused_step_flat", 0) == \
        (5 if fused else 0)


def _layout_bytes(built):
    """(Σ blocks of the sharded leaves, Σ blocks, Σ full leaves, n sharded,
    n leaves) of one client's fp32 params on this rank."""
    lay = built.meta["shard_plan"].layout
    sharded = blocks = full = n_sh = 0
    for g, s in zip(lay.global_shapes, lay.local.shapes):
        b, f = 4 * int(np.prod(s)), 4 * int(np.prod(g))
        blocks += b
        full += f
        if b < f:
            sharded += b
            n_sh += 1
    return sharded, blocks, full, n_sh, len(lay.global_shapes)


@pytest.mark.parametrize("mode", ["paper", "paper_fsdp"])
def test_round_collectives_are_the_designs(mode):
    """Reduced qwen2-0.5b, savic, H = 2 on a fake 2×2 (clients on ``data``;
    the params' blocks on ``model``): per local step one gather of each
    sharded leaf over the shard axes and, under fsdp, the gradient's and
    the loss's mean over the batch axes (an all-reduce of each full leaf
    and of the loss); at the sync the (H, M) losses gathered over the
    clients, four all-reduces of each block over the clients (the drift's
    mean, the params' and the momentum's averages, the D statistic's
    average) and two scalar sums (the drift over the shards, then over the
    clients)."""
    H = 2
    with dryrun.fake_world(4):
        built = _built(mode, h_local=H)
        t, *_ = dryrun._trace_train(built, "cpu")
    r = cost.summary(t)
    sharded, blocks, full, n_sh, n = _layout_bytes(built)
    fsdp = mode == "paper_fsdp"
    assert r["collective_by_kind"] == {
        "all-gather": H * sharded + H * 4,
        "all-reduce": H * (full + 4 if fsdp else 0) + 4 * blocks + 2 * 4}
    assert r["collective_counts"] == {
        "all-gather": H * n_sh + 1,
        "all-reduce": H * (n + 1 if fsdp else 0) + 4 * n + 2}


def test_reduced_train_flops_equal_the_references_hlo_cost():
    """The reduced savic round (H = 2, b = 2, S = 32) on one rank against
    the reference's ``hlo_cost.analyze`` of the same step lowered on one
    CPU device: every matmul the same, so the FLOPs are equal."""
    from jax.sharding import Mesh

    from repro.configs import ShapeConfig as JShape
    from repro.launch.steps import build_train_step as jbuild
    from repro.utils.hlo_cost import analyze
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1),
                ("data", "model"))
    b = jbuild("qwen2-0.5b", JShape("tiny", 32, 2, "train"), mesh,
               mode="paper", reduced=True, h_local=2)
    with mesh:
        hlo = jax.jit(b.fn, in_shardings=b.in_shardings,
                      out_shardings=b.out_shardings).lower(
            *b.args).compile().as_text()
    want = analyze(hlo)["flops"]
    rec = dryrun.run_one("qwen2-0.5b", "tiny",
                         shape=ShapeConfig("tiny", 32, 2, "train"),
                         reduced=True, mesh_shape=(1, 1), h_local=2,
                         save=False, verbose=False)
    assert rec["flops"] == want


def test_train_argv_prediction_equals_the_cpu_run():
    """``run_train_argv`` against ``train.main`` with the same arguments on
    a 1×1 gloo mesh (reduced qwen2-0.5b, plain on the fused loop, 2
    rounds): the real rounds' FLOPs (``FlopCounterMode``) are twice the
    predicted round's, and each round's arguments (the rank's state and
    the int64 round batch) have the predicted bytes. ``chip_smoke.py``
    phase 15 makes the same check on the card, K1's launches with it."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import train
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--method", "savic",
            "--rounds", "2", "--h-local", "2", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--mesh", "debug", "--mesh-shape", "1x1",
            "--mode", "plain", "--use-fused-kernel"]
    rec = dryrun.run_train_argv(argv, save=False, verbose=False)
    assert rec["custom_counts"] == {"repro_torch.fused_step_flat": 2}
    seen, orig = [], steps.build_train_step

    def build(*a, **k):
        built = orig(*a, **k)
        fn = built.fn

        def step(state, batch, stream=None):
            seen.append(sum(x.numel() * x.element_size()
                            for x in tree_leaves((state, batch))))
            return fn(state, batch, stream)
        built.fn = step
        return built

    steps.build_train_step = build
    try:
        with FlopCounterMode(display=False) as fc:
            train.main(argv)
    finally:
        steps.build_train_step = orig
    assert fc.get_total_flops() == 2 * rec["flops"]
    assert seen == [rec["memory"]["argument_size_in_bytes"]] * 2


# --------------------------------------------------------------------------- #
# run_one's records
# --------------------------------------------------------------------------- #

KEYS = {"arch", "shape", "mesh", "n_devices", "tag", "kind", "mode",
        "method", "clients", "h_local", "flops", "bytes_accessed",
        "collective_bytes", "collective_by_kind", "collective_counts",
        "memory", "params", "active_params", "op_census", "ok", "peak_bytes",
        "flops_by_dtype", "trace_s", "roofline"}
TRAIN_KEYS = {"compression", "sync_payload_per_client", "asynchrony",
              "heterogeneity", "local_steps_traced", "trip_count"}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b"])
def test_run_one_writes_the_records(arch, tmp_path):
    for shape in (TRAIN, PREFILL, DECODE):
        rec = dryrun.run_one(arch, shape.name, shape=shape, reduced=True,
                             mesh_shape=(2, 2), h_local=4,
                             out_dir=str(tmp_path), verbose=False)
        path = tmp_path / f"{arch}__{shape.name}__2x2.json"
        assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
        assert rec["ok"] and KEYS <= set(rec)
        if shape.kind == "train":
            assert TRAIN_KEYS <= set(rec)
            assert (rec["local_steps_traced"], rec["trip_count"]) == (5, 4)
            assert rec["mode"] == "paper" and rec["clients"] == 2
        else:
            assert rec["mode"] == "serve"
        assert rec["flops"] == sum(rec["flops_by_dtype"].values()) > 0
        assert rec["peak_bytes"] >= rec["memory"]["argument_size_in_bytes"]
        assert set(rec["roofline"]) >= {"compute_s", "memory_s",
                                        "collective_s", "dominant",
                                        "roofline_frac", "fits"}


def _sync_record(tmp_path, **kw):
    return dryrun.run_one("qwen2-0.5b", TRAIN.name, shape=TRAIN, reduced=True,
                          mesh_shape=(2, 2), h_local=2, mode="plain",
                          out_dir=str(tmp_path), verbose=False, **kw)


def test_run_one_records_compression_on_a_sharded_plan(tmp_path):
    """Compression on a plan whose shard axes split the leaves (plain on
    2x2) traces: top-k's record is ``ok: true`` with the candidates'
    all-gather on top of the param gathers, int8's with the MAX
    all-reduce of its scales on top of the sync's all-reduces."""
    base = _sync_record(tmp_path)
    topk = _sync_record(tmp_path, compression=engine.CompressionSpec(
        op="topk", k=0.1))
    int8 = _sync_record(tmp_path, compression=engine.CompressionSpec(
        op="int8-stochastic"))
    assert base["ok"] and topk["ok"] and int8["ok"]
    assert topk["collective_by_kind"]["all-gather"] > \
        base["collective_by_kind"]["all-gather"] > 0
    assert topk["collective_counts"]["all-gather"] > \
        base["collective_counts"]["all-gather"]
    assert int8["collective_counts"]["all-reduce"] > \
        base["collective_counts"]["all-reduce"]
    ctrl = _sync_record(tmp_path, compression=engine.CompressionSpec(
        op="topk", k=0.1, error_feedback=True),
        controller=engine.ControllerSpec(enabled=True, h_max=2))
    assert ctrl["ok"] is True
    _holds_controller_block(ctrl, engine.ControllerSpec(enabled=True,
                                                        h_max=2))
    assert ctrl["local_steps_traced"] == ctrl["trip_count"] == 2


def _holds_controller_block(rec, spec):
    """The record's ``controller`` block is the reference's: the spec, the
    initial knobs and the state leaves' shapes of
    ``repro.core.controller.init_ctrl_state``."""
    import dataclasses
    from repro.core import controller as jctrl
    want = jctrl.init_ctrl_state(
        jctrl.ControllerSpec(**dataclasses.asdict(spec)), rec["clients"])
    block = json.loads(json.dumps(rec["controller"]))
    assert set(block) == {"spec", "init_knobs", "state_leaves"}
    assert block["spec"] == json.loads(json.dumps(dataclasses.asdict(spec)))
    assert block["init_knobs"] == {
        "h_m": [int(h) for h in np.asarray(want["h_m"])],
        "k": float(want["k"]), "b_eff": int(want["b_eff"])}
    assert block["state_leaves"] == {k: list(np.shape(v))
                                     for k, v in want.items()}


@pytest.mark.parametrize("h_max,buffer", [(5, 0), (6, 2)])
def test_controller_round_traced_whole_at_its_h(h_max, buffer, tmp_path):
    """A controller round with h_max > 3 (the extrapolation's bases) gives
    an ``ok`` record, traced whole at H; the knobs it is traced at are the
    initial ones (H_t = h_min = 1: one local step a client, so its FLOPs
    are those of a round at H = 1 with the same H microbatches in), and the
    state it writes back keeps the controller's leaves."""
    spec = engine.ControllerSpec(
        enabled=True, h_max=h_max, buffer_max=buffer,
        step_times=(1.0, 1.7) if buffer else ())
    asy = engine.AsyncSpec(buffer_rounds=buffer) if buffer else None
    rec = dryrun.run_one("qwen2-0.5b", TRAIN.name, shape=TRAIN, reduced=True,
                         mesh_shape=(2, 2), h_local=h_max,
                         out_dir=str(tmp_path), verbose=False,
                         controller=spec, asynchrony=asy)
    assert rec["ok"] is True and rec["clients"] == 2
    assert rec["local_steps_traced"] == rec["trip_count"] == h_max
    _holds_controller_block(rec, spec)
    if not buffer:
        assert rec["controller"]["init_knobs"]["h_m"] == [1, 1]
    assert rec["flops"] > 0 and rec["peak_bytes"] > 0


def test_fake_world_refuses_a_live_group():
    with dryrun.fake_world(2):
        with pytest.raises(RuntimeError, match="already up"):
            with dryrun.fake_world(2):
                pass


# --------------------------------------------------------------------------- #
# the H100 terms and the train_lm projection rows
# --------------------------------------------------------------------------- #

REC = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16",
       "n_devices": 256, "tag": "", "kind": "train", "mode": "paper",
       "seq_len": 4096, "global_batch": 256, "h_local": 8, "ok": True,
       "active_params": 494_005_120, "flops": 3.0e15,
       "flops_by_dtype": {"bfloat16": 2.9e15, "float32": 1.0e14},
       "bytes_accessed": 2.0e14, "collective_bytes": 3.0e9,
       "collective_intra_bytes": 1.0e9, "collective_inter_bytes": 2.0e9,
       "peak_bytes": 9.0e10}


def test_roofline_terms_by_hand():
    t = roofline.terms(REC)
    comp = 2.9e15 / 989e12 + 1.0e14 / 67e12
    assert t["compute_s"] == pytest.approx(comp, rel=1e-12)
    assert t["memory_s"] == pytest.approx(2.0e14 / 3.35e12, rel=1e-12)
    assert t["collective_s"] == pytest.approx(1e9 / 450e9 + 2e9 / 50e9,
                                              rel=1e-12)
    assert t["dominant"] == "memory"
    mf = 6 * 494_005_120 * 256 * 4096 * 8 / 256
    assert t["model_flops_per_dev"] == pytest.approx(mf, rel=1e-12)
    assert t["roofline_frac"] == pytest.approx(
        (mf / 989e12) / (2.0e14 / 3.35e12), rel=1e-12)
    assert t["fits"] is False       # 90 GB > 80 GB


def test_projection_rows_by_hand(tmp_path):
    (tmp_path / "qwen2-0.5b__train_4k__16x16.json").write_text(
        json.dumps(REC))
    (tmp_path / "qwen2-0.5b__prefill_32k__16x16.json").write_text(
        json.dumps({**REC, "kind": "prefill", "shape": "prefill_32k"}))
    (tmp_path / "qwen2-0.5b__train_4k__2x16x16.json").write_text(
        json.dumps({**REC, "mesh": "2x16x16", "ok": False}))
    rows = train_lm.projection_rows(ddir=str(tmp_path))
    assert len(rows) == 1
    row = rows[0]
    assert row["coords"] == {"method": "projection:train_4k@16x16"}
    tokens = 256 * 4096 * 8
    bound = 2.0e14 / 3.35e12
    comp = 2.9e15 / 989e12 + 1.0e14 / 67e12
    m = row["metrics"]
    assert m["n_devices"] == 256 and m["tokens_per_round"] == tokens
    assert m["round_s_roofline"] == round(bound, 6)
    assert m["tok_s_dev_roofline"] == round(tokens / 256 / bound, 1)
    assert m["tok_s_dev_compute_bound"] == round(tokens / 256 / comp, 1)
    assert row["info"]["dominant_term"] == "memory"
    assert train_lm.summary(rows) == [("tok_s_dev_proj_train_4k",
                                       m["tok_s_dev_roofline"])]


# --------------------------------------------------------------------------- #
# the two riders
# --------------------------------------------------------------------------- #

def _trees(seed=0):
    r = np.random.default_rng(seed)
    shapes = {"w": (5, 3), "b": (3,)}
    return [{k: r.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(4)]


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_inner_optimizers_match_the_reference(wd):
    from repro.optim import inner as jinner
    from repro_torch.optim import inner
    p, m, g, v = _trees()
    v = {k: np.abs(x) for k, x in v.items()}
    J = lambda t: {k: jnp.asarray(x) for k, x in t.items()}
    T = lambda t: {k: torch.from_numpy(x) for k, x in t.items()}
    close = lambda a, b: [np.testing.assert_allclose(
        a[k].numpy(), np.asarray(b[k]), rtol=1e-6, atol=1e-7) for k in a]
    for got, want in zip(inner.sgd_step(T(p), T(m), T(g), 0.1, beta1=0.9,
                                        weight_decay=wd),
                         jinner.sgd_step(J(p), J(m), J(g), 0.1, beta1=0.9,
                                         weight_decay=wd)):
        close(got, want)
    for t in (0, 7):
        got = inner.adamw_step(T(p), T(m), T(v), T(g), 1e-3,
                               torch.tensor(t, dtype=torch.int32),
                               weight_decay=wd)
        want = jinner.adamw_step(J(p), J(m), J(v), J(g), 1e-3,
                                 jnp.asarray(t, jnp.int32), weight_decay=wd)
        for a, b in zip(got, want):
            close(a, b)


def test_serve_batched_example_gives_the_references_ids():
    """``examples/serve_batched_torch.py`` on reduced qwen2-0.5b against
    the reference example's call (``repro.launch.serve.serve``) with the
    same prompt and the reference's seed-0 weights."""
    from repro.configs import get_config as jget_config
    from repro.launch import serve as jserve
    from repro.models import ModelCallConfig as JCall
    from repro.models import build as jbuild
    from repro_torch.bridge import params_from_jax
    path = os.path.join(ROOT, "examples", "serve_batched_torch.py")
    spec = importlib.util.spec_from_file_location("_ex_serve_batched", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    jcfg = jget_config("qwen2-0.5b", reduced=True)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    want = jserve.serve("qwen2-0.5b", reduced=True, batch=2, prompt_len=8,
                        gen_len=6, seed=0, prompt={
                            "tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(toks)}, verbose=False)
    got = ex.main(["--arch", "qwen2-0.5b", "--batch", "2", "--prompt-len",
                   "8", "--gen-len", "6", "--device", "cpu"],
                  prompt={"tokens": torch.from_numpy(toks)},
                  params=params_from_jax(jp, "cpu"))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
