"""The port's checkpoint (``repro_torch.checkpoint``, its msgpack codec
``repro_torch.utils.msgpack``), ``train.main``'s resume, the configs
registry and the ``train_lm`` runner, held against the reference.

* The codec equals ``msgpack.packb`` byte for byte over a seeded corpus
  (every width boundary) and real manifests, and reads what it packs.
* The reference's checkpoint tests (``tests/test_checkpoint.py``,
  ``tests/test_data.py``, the controller's and personalization's
  roundtrips) on the port's tensors.
* Across packages, reduced qwen2-0.5b through ``tests/_torch_parity.py``:
  a state saved by ``repro.checkpoint.save`` after round 1 restores into
  the port's own template, and the port's round 2 equals the reference's
  at the harness's tolerances (state 1e-5 of its entry's scale, loss 1e-5
  relative, drift 1e-4, step norm 1e-3, compression error 1e-3); a state
  the port saves is byte for byte the reference's files for it.
* ``train.main``: train(T) equals train(t) + restore + train(T − t) in
  every log field but ``wall_s`` and ``tokens_per_s``, and in the final
  checkpoint's bytes, under every optional state group.
* ``launch/train_lm.py``'s rows against ``benchmarks/run.py``'s
  ``_run_train_lm`` from the reference's initial weights: losses at 1e-5
  relative (tests/test_torch_train.py's tolerance) plus 1e-4 absolute, the
  unit of the rows' fourth decimal, to which both round.
"""
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (M, assert_metrics_close, assert_state_close,
                           batches, models)
from _torch_rng_replay import JaxStream
from repro import checkpoint as jckpt
from repro.configs import ModelConfig as JModelConfig
from repro.configs import get_config as jget_config
from repro.core import controller as JCTRL
from repro.core import engine as jeng
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.core import controller as CTRL
from repro_torch.core import engine
from repro_torch.launch import train, train_lm
from repro_torch.utils import msgpack as mp
from repro_torch.utils.tree import tree_map, tree_paths

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# the msgpack codec
# --------------------------------------------------------------------------- #

def _corpus():
    """Width boundaries of every family, then seeded nested objects."""
    ints = [0, 1, 127, 128, 255, 256, 2 ** 16 - 1, 2 ** 16, 2 ** 32 - 1,
            2 ** 32, 2 ** 63, 2 ** 64 - 1, 17_840_000_000, -1, -32, -33,
            -128, -129, -2 ** 15, -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1,
            -2 ** 63]
    strs = ["", "a" * 31, "a" * 32, "b" * 255, "b" * 256, "c" * 65535,
            "c" * 65536, "é漢字", "é" * 16]
    seqs = [list(range(15)), list(range(16)), tuple(range(3)),
            list(range(65535)), list(range(65536)), [],
            {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
            {f"k{i}": None for i in range(65536)}, {}]
    out = ints + strs + seqs + [True, False, None]
    rng = np.random.default_rng(0)

    def obj(depth):
        kind = rng.integers(0, 7 if depth < 3 else 4)
        if kind == 0:
            n = int(rng.choice(ints)) + int(rng.integers(-2, 3))
            return min(max(n, -2 ** 63), 2 ** 64 - 1)
        if kind == 1:
            n = int(rng.choice([0, 5, 31, 32, 255, 256]))
            return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, n))
        if kind == 2:
            return [None, True, False][int(rng.integers(0, 3))]
        if kind == 3:
            return int(rng.integers(-2 ** 40, 2 ** 40))
        n = int(rng.choice([0, 1, 15, 16, 17]))
        if kind == 4:
            return [obj(depth + 1) for _ in range(n)]
        if kind == 5:
            return tuple(obj(depth + 1) for _ in range(n))
        return {f"key{i}_{int(rng.integers(0, 1 << 20))}": obj(depth + 1)
                for i in range(n)}

    return out + [obj(0) for _ in range(40)]


CORPUS = _corpus()


def _manifest(n_leaves, nbytes):
    """A manifest as ``save`` writes it, offsets past 2^32 at full sizes."""
    leaves, off = [], 0
    for i in range(n_leaves):
        leaves.append({"path": f"params/layers/{i}/w", "shape": [4, nbytes
                                                                 // 16],
                       "dtype": "float32", "offset": off, "nbytes": nbytes})
        off += nbytes
    return {"magic": "repro-ckpt-v1", "step": 12, "leaves": leaves}


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_codec_matches_msgpack(i):
    msgpack = pytest.importorskip("msgpack")
    obj = CORPUS[i]
    want = msgpack.packb(obj)
    assert mp.packb(obj) == want
    assert mp.unpackb(want) == msgpack.unpackb(want)


@pytest.mark.parametrize("n_leaves,nbytes", [(3, 64), (40, 2_203_000_000),
                                             (8, 9_000_000_000)])
def test_codec_matches_msgpack_on_manifests(n_leaves, nbytes):
    msgpack = pytest.importorskip("msgpack")
    m = _manifest(n_leaves, nbytes)
    assert mp.packb(m) == msgpack.packb(m)
    assert mp.unpackb(mp.packb(m)) == m


def test_codec_offset_past_2_32_is_uint64():
    assert mp.packb(17_840_000_000) == bytes.fromhex("cf000000042758cc00")
    assert mp.unpackb(bytes.fromhex("cf000000042758cc00")) == 17_840_000_000


@pytest.mark.parametrize("bad", [1.0, float("nan"), b"x", bytearray(b"x"),
                                 {1: 2}, object(), np.int64(3),
                                 np.float32(1.0), {"a": [1, 2.5]}])
def test_codec_refuses_what_the_manifest_never_holds(bad):
    with pytest.raises(TypeError):
        mp.packb(bad)


@pytest.mark.parametrize("n", [2 ** 64, -2 ** 63 - 1])
def test_codec_refuses_ints_out_of_range(n):
    with pytest.raises(OverflowError):
        mp.packb(n)


@pytest.mark.parametrize("raw,want", [
    ("cd0001", 1), ("ce00000001", 1), ("cf0000000000000001", 1),
    ("d0ff", -1), ("d1ffff", -1), ("d2ffffffff", -1),
    ("d3ffffffffffffffff", -1), ("d90161", "a"), ("da000161", "a"),
    ("db0000000161", "a"), ("dc000101", [1]), ("dd0000000101", [1]),
    ("de0001a16101", {"a": 1}), ("df00000001a16101", {"a": 1}),
])
def test_unpackb_reads_every_width(raw, want):
    assert mp.unpackb(bytes.fromhex(raw)) == want


@pytest.mark.parametrize("raw", ["cb3ff0000000000000", "c40161", "91",
                                 "0101", "81c0c0", "d9"])
def test_unpackb_refuses_outside_the_subset(raw):
    with pytest.raises(ValueError):
        mp.unpackb(bytes.fromhex(raw))


# --------------------------------------------------------------------------- #
# the reference's checkpoint tests, on the port
# --------------------------------------------------------------------------- #

def _orphan_tmp(ckpt_dir, step):
    """Simulate a save that crashed mid-write."""
    d = os.path.join(str(ckpt_dir), f"step_{step:08d}.tmp")
    os.makedirs(d)
    with open(os.path.join(d, "data.bin"), "wb") as f:
        f.write(b"partial garbage")
    return d


def _assert_same(got, want):
    g = dict(tree_paths(got))
    assert g.keys() == dict(tree_paths(want)).keys()
    for p, leaf in tree_paths(want):
        assert g[p].dtype == leaf.dtype, p
        assert g[p].device == leaf.device, p
        assert torch.equal(g[p], leaf), p


def test_crashed_save_tmp_cleaned_on_next_save(tmp_path):
    state = {"x": torch.arange(4, dtype=torch.float32)}
    _orphan_tmp(tmp_path, 7)
    assert ckpt.latest_step(str(tmp_path)) is None     # tmp never counts
    ckpt.save(str(tmp_path), 9, state)
    left = os.listdir(tmp_path)
    assert not any(d.endswith(".tmp") for d in left), left
    assert ckpt.latest_step(str(tmp_path)) == 9
    # crashed re-save of an existing step: stale tmp goes, checkpoint stays
    _orphan_tmp(tmp_path, 9)
    ckpt.save(str(tmp_path), 12, state)
    left = os.listdir(tmp_path)
    assert not any(d.endswith(".tmp") for d in left), left
    out, step = ckpt.restore(str(tmp_path), state)
    assert step == 12
    _assert_same(out, state)


def test_orphan_tmps_do_not_accumulate(tmp_path):
    state = {"x": torch.zeros(2)}
    for s in range(3):
        _orphan_tmp(tmp_path, 100 + s)
    ckpt.save(str(tmp_path), 1, state)
    assert sum(d.endswith(".tmp") for d in os.listdir(tmp_path)) == 0


def _arange_like(state):
    """Non-trivial values in every float leaf (zeros round-trip
    trivially)."""
    return tree_map(lambda x: x + torch.arange(x.numel(), dtype=x.dtype)
                    .reshape(x.shape) if x.is_floating_point() else x, state)


def test_engine_state_roundtrip_server_ef_buffer(tmp_path):
    spec = engine.method_spec(
        "fedadam", compression=engine.CompressionSpec(
            op="topk", k=0.5, error_feedback=True),
        asynchrony=engine.AsyncSpec(buffer_rounds=2))
    init = lambda g: {"w": torch.randn(3, 4, generator=g),
                      "b": torch.randn(4, generator=g)}
    state = engine.init_state(torch.Generator().manual_seed(0), init, spec,
                              3)
    assert {"server", "ef", "buffer"} <= set(state)
    state = _arange_like(state)
    ckpt.save(str(tmp_path), 5, state)
    out, step = ckpt.restore(str(tmp_path), tree_map(torch.zeros_like,
                                                     state))
    assert step == 5
    _assert_same(out, state)


def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(12, dtype=torch.float32)
                        .reshape(3, 4)},
             "step": torch.tensor(7, dtype=torch.int32),
             "nested": [torch.ones(2),
                        {"b": torch.zeros(1, dtype=torch.bfloat16)}]}
    ckpt.save(str(tmp_path), 3, state)
    ckpt.save(str(tmp_path), 9, state)
    assert ckpt.latest_step(str(tmp_path)) == 9
    out, step = ckpt.restore(str(tmp_path), state)
    assert step == 9
    assert out["nested"][1]["b"].dtype == torch.bfloat16
    assert out["step"].shape == ()
    _assert_same(out, state)


def test_checkpoint_gc(tmp_path):
    state = {"x": torch.zeros(4)}
    for s in range(6):
        ckpt.save(str(tmp_path), s, state, keep=3)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert left == ["step_00000003", "step_00000004", "step_00000005"]


def test_every_dtype_roundtrips_and_takes_the_checkpoints_dtype(tmp_path):
    """Every dtype of the table, scalar and empty leaves; a leaf comes back
    in the checkpoint's dtype whatever the template's, and a shape mismatch
    raises the reference's message."""
    g = torch.Generator().manual_seed(0)
    state = {"f32": torch.randn(3, 5, generator=g),
             "f16": torch.randn(4, generator=g).half(),
             "bf16": torch.randn(2, 3, generator=g).bfloat16(),
             "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
             "u8": torch.tensor([0, 255], dtype=torch.uint8),
             "i32": torch.tensor(-7, dtype=torch.int32),
             "u32": torch.tensor([0, 2 ** 32 - 1], dtype=torch.uint32),
             "i64": torch.tensor([-2 ** 63, 2 ** 63 - 1]),
             "b": torch.tensor([True, False, True]),
             "empty": torch.zeros(0, 3), "none": None}
    ckpt.save(str(tmp_path), 1, state)
    out, _ = ckpt.restore(str(tmp_path), tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float64), state))
    _assert_same(out, state)
    assert out["none"] is None
    bad = dict(state, f32=torch.zeros(5, 3))
    with pytest.raises(ValueError, match=r"f32: ckpt \(3, 5\) != template "
                                         r"\(5, 3\)"):
        ckpt.restore(str(tmp_path), bad)


def test_restore_streams_by_offset_and_checks_the_magic(tmp_path):
    """A truncated data.bin raises; a foreign manifest raises."""
    state = {"a": torch.ones(8), "b": torch.ones(8)}
    path = ckpt.save(str(tmp_path), 1, state)
    with open(os.path.join(path, "data.bin"), "r+b") as f:
        f.truncate(40)
    with pytest.raises(ValueError, match="ends inside"):
        ckpt.restore(str(tmp_path), state)
    with open(os.path.join(path, "state.msgpack"), "wb") as f:
        f.write(mp.packb({"magic": "other", "step": 1, "leaves": []}))
    with pytest.raises(ValueError, match="repro-ckpt-v1"):
        ckpt.restore(str(tmp_path), state)


def test_restore_raises_without_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(1)})


def test_ctrl_state_checkpoint_roundtrip(tmp_path):
    from _torch_parity import QUAD_KW, quad_run_port
    ctrl = CTRL.ControllerSpec(enabled=True, h_min=1, h_max=4,
                               noise_target=0.05, resid_guard=0.3,
                               step_times=(1.0, 1.5, 2.0, 2.5))
    spec = engine.method_spec(
        "fedadam", **QUAD_KW, compression=engine.CompressionSpec(
            op="topk", k=0.5, error_feedback=True), controller=ctrl)
    state, _ = quad_run_port(spec, rounds=3, H=4)
    assert "ctrl" in state and int(state["ctrl"]["t"]) == 3
    ckpt.save(str(tmp_path), 3, state)
    out, step = ckpt.restore(str(tmp_path), tree_map(torch.zeros_like,
                                                     state))
    assert step == 3
    _assert_same(out, state)


def test_personal_state_checkpoint_roundtrip(tmp_path):
    """None-stripped server/EF trees ride the path manifest bitwise (None
    subtrees have no leaves to save)."""
    from _torch_parity import (QUAD_KW, quad_batches, quad_losses,
                               quad_port_state, quad_torch_batch)
    spec = engine.method_spec("fedadam", **QUAD_KW, personal=("head",),
                              compression="topk", compression_k=0.5,
                              error_feedback=True)
    step = engine.build_round_step(quad_losses(None)[1], spec)
    state = quad_port_state(spec, {"x": torch.zeros(24),
                                   "head": torch.full((3,), 2.0)})
    (nb, k), = quad_batches(1, 3)
    state, _ = step(state, quad_torch_batch(nb), JaxStream(k))
    assert state["server"]["m"]["head"] is None
    assert state["ef"]["head"] is None
    ckpt.save(str(tmp_path), 1, state)
    out, step_no = ckpt.restore(str(tmp_path), state)
    assert step_no == 1
    assert out["server"]["m"]["head"] is None and out["ef"]["head"] is None
    _assert_same(out, state)


# --------------------------------------------------------------------------- #
# across packages: reduced qwen2-0.5b, M = 2
# --------------------------------------------------------------------------- #

def _ctrl_kw():
    return dict(enabled=True, h_min=1, h_max=2, noise_target=1e-3,
                buffer_max=2, step_times=(1.0, 1.7))


# name -> (method, kwargs of both packages' method_spec, port fused?)
CROSS = {
    "savic-k1": ("savic", {}, True),
    "fedadam-topk-ef-fifo-ctrl": (
        "fedadam", dict(compression="topk", compression_k=0.5,
                        error_feedback=True, async_buffer=2), True),
    "local-adam-local-oasis": ("local-adam", dict(pc_kind="oasis"), True),
    "fedadam-personal": ("fedadam", dict(personal=("final_norm",)), False),
}


def _specs(name):
    method, kw, fused = CROSS[name]
    jkw, pkw = dict(kw), dict(kw)
    if "ctrl" in name:
        jkw["controller"] = JCTRL.ControllerSpec(**_ctrl_kw())
        pkw["controller"] = CTRL.ControllerSpec(**_ctrl_kw())
    return (jeng.method_spec(method, gamma=3e-3, eta_l=3e-3, **jkw),
            engine.method_spec(method, gamma=3e-3, eta_l=3e-3,
                               use_fused_kernel=fused, **pkw))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """name -> (checkpoint dir of round 1, state after round 1 (numpy),
    state after round 2, round 2's metrics): the reference's tree path,
    round r keyed PRNGKey(r)."""
    cache = {}

    def get(name):
        if name not in cache:
            jspec, _ = _specs(name)
            _, jm, _ = models()
            state = jeng.init_state(jax.random.PRNGKey(0), jm.init, jspec, M)
            step = jax.jit(jeng.build_round_step(jm.loss, jspec))
            b = [jax.tree.map(jnp.asarray, nb) for nb in batches()]
            state, _ = step(state, b[0], jax.random.PRNGKey(0))
            s1 = jax.device_get(state)
            d = str(tmp_path_factory.mktemp(name))
            jckpt.save(d, 1, s1)
            state, met = step(state, b[1], jax.random.PRNGKey(1))
            cache[name] = (d, s1, jax.device_get(state),
                           jax.device_get(met))
        return cache[name]
    return get


def _files(path):
    out = {}
    for f in ("state.msgpack", "data.bin"):
        with open(os.path.join(path, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("name", list(CROSS))
def test_reference_checkpoint_restores_into_the_port(name, reference):
    """The port's own initial state is the template: the same leaf paths,
    shapes and dtypes as the reference's. Restored, every leaf is the
    reference's bitwise, and the port's round 2 is the reference's."""
    d, s1, want, wmet = reference(name)
    _, spec = _specs(name)
    _, _, tm = models()
    template = engine.init_state(torch.Generator(), tm.init, spec, M)
    state, step = ckpt.restore(d, template)
    assert step == 1
    got1 = dict(tree_paths(state))
    assert got1.keys() == dict(jtree_paths(s1)).keys()
    for p, w in jtree_paths(s1):
        np.testing.assert_array_equal(got1[p].numpy(), np.asarray(w),
                                      err_msg=p)
    batch = {k: torch.from_numpy(v).long() for k, v in batches()[1].items()}
    step_fn = engine.build_round_step(tm.loss, spec)
    got, met = step_fn(state, batch, JaxStream(jax.random.PRNGKey(1)))
    # the FIFO holds averaged deltas x̄ − x, which cancel to ulps of x: its
    # scale is the matching params leaf's, as for server m and the EF
    # residual in assert_state_close
    fifo = got.pop("buffer", None)
    # the controller's EMAs are built from the reference's CPU vdot sums
    # (~1e-4 relative at LM sizes): 1e-3 relative, as in
    # tests/test_torch_train.py; its integer knobs exactly
    ctrl, want = got.pop("ctrl", None), dict(want)
    wctrl = want.pop("ctrl", None)
    for k, g in (ctrl or {}).items():
        np.testing.assert_allclose(g.numpy(), np.asarray(wctrl[k]),
                                   rtol=1e-3 if g.is_floating_point() else 0,
                                   err_msg="ctrl/" + k)
    assert_state_close(got, {k: v for k, v in want.items() if k != "buffer"})
    assert (fifo is None) == ("buffer" not in want)
    wd = dict(jtree_paths(want))
    for p, g in tree_paths(fifo):
        sc = float(np.abs(np.asarray(wd["params/" + p])).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(wd["buffer/" + p]),
                                   rtol=0, atol=1e-5 * sc,
                                   err_msg="buffer/" + p)
    assert_metrics_close([met], [wmet])


@pytest.mark.parametrize("name", list(CROSS))
def test_port_checkpoint_is_the_reference_files(name, reference, tmp_path):
    """The reference's state carried across by the bridge and saved by the
    port: state.msgpack and data.bin byte for byte the reference's, and
    ``repro.checkpoint.restore`` reads them back."""
    d, s1, _, _ = reference(name)
    path = ckpt.save(str(tmp_path), 1, state_from_jax(s1, "cpu"))
    assert _files(path) == _files(os.path.join(d, "step_00000001"))
    out, step = jckpt.restore(str(tmp_path), jax.tree.map(jnp.asarray, s1))
    assert step == 1
    got = dict(jtree_paths(out))
    for p, w in jtree_paths(s1):
        np.testing.assert_array_equal(np.asarray(got[p]), np.asarray(w),
                                      err_msg=p)


def test_bf16_leaf_crosses_both_ways(reference, tmp_path):
    """A state with bf16 leaves (a scalar among them): the port's files are
    the reference's bytes, and each package restores the other's bitwise,
    bf16 as bf16."""
    _, s1, _, _ = reference("savic-k1")
    js = dict(s1, half={"w": jnp.asarray(s1["params"]["final_norm"]["scale"],
                                         jnp.bfloat16),
                        "s": jnp.asarray(1.5, jnp.bfloat16)})
    js = jax.device_get(js)
    jckpt.save(str(tmp_path / "ref"), 4, js)
    path = ckpt.save(str(tmp_path / "port"), 4, state_from_jax(js, "cpu"))
    assert _files(path) == _files(str(tmp_path / "ref" / "step_00000004"))
    out, _ = ckpt.restore(str(tmp_path / "ref"), state_from_jax(js, "cpu"))
    assert out["half"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["half"]["w"], state_from_jax(js, "cpu")["half"]
                       ["w"])
    jout, _ = jckpt.restore(str(tmp_path / "port"),
                            jax.tree.map(jnp.asarray, js))
    assert jout["half"]["s"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jout["half"]["w"]).view(np.uint16),
        np.asarray(js["half"]["w"]).view(np.uint16))


# --------------------------------------------------------------------------- #
# train.main resume
# --------------------------------------------------------------------------- #

BASE = ["--arch", "qwen2-0.5b", "--reduced", "--h-local", "2",
        "--clients", "2", "--batch", "2", "--seq", "32", "--device", "cpu"]
MEASURED = ("wall_s", "tokens_per_s")
# every optional state group at once: server m/v, the EF residual, the
# FIFO, the controller, local D with its per-client t, a personal leaf,
# lognormal H_m (the controller's straggler trace), the fused loop
ALL_GROUPS = ["--method", "local-adam", "--use-fused-kernel", "--h-local",
              "4", "--controller", "--async-buffer", "2", "--het-model",
              "lognormal", "--het-seed", "2", "--compression", "topk",
              "--compression-k", "0.1", "--error-feedback",
              "--ctrl-noise-target", "1e-3", "--personalize", "final_norm"]


def _det(rec):
    return {k: v for k, v in rec.items() if k not in MEASURED}


@pytest.mark.parametrize("flags,t,T", [
    ([], 3, 6),
    (["--use-fused-kernel"], 2, 4),
    (["--method", "fedadam", "--use-fused-kernel", "--compression",
      "int8-stochastic", "--error-feedback"], 2, 4),
    (ALL_GROUPS, 2, 4),
], ids=["savic-tree", "savic-fused", "fedadam-int8-ef-fused", "all-groups"])
def test_resume_bitwise_loss_state_log(tmp_path, capsys, flags, t, T):
    """train(T) == train(t) + restore + train(T − t), bitwise: every
    deterministic log field, and the final checkpoint's raw bytes."""
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    argv = BASE + flags
    log_a = train.main(argv + ["--rounds", str(T), "--ckpt", da,
                               "--ckpt-every", str(t)])
    train.main(argv + ["--rounds", str(t), "--ckpt", db, "--ckpt-every",
                       str(t)])
    capsys.readouterr()
    log_b = train.main(argv + ["--rounds", str(T), "--ckpt", db,
                               "--ckpt-every", str(t)])
    assert f"[train] restored round {t} " in capsys.readouterr().out
    assert [r["round"] for r in log_b] == list(range(t, T))
    for ra, rb in zip(log_a[t:], log_b):
        assert _det(ra) == _det(rb)
    step = f"step_{T:08d}"
    assert _files(os.path.join(da, step)) == _files(os.path.join(db, step))
    if flags is ALL_GROUPS:
        state, _ = ckpt.restore(db, train.setup(argv).state)
        assert {"server", "ef", "buffer", "ctrl"} <= set(state)
        assert state["precond"]["t"].shape == (2,)
        assert state["server"]["m"]["final_norm"]["scale"] is None


def test_share_replicas_restores_the_rounds_layout(tmp_path):
    """After a sync the round holds each synced params leaf (and averaged
    momentum) as one replica expanded to M rows; a restored state holds M
    copies. ``share_replicas`` expands the bitwise-equal ones again and
    leaves the rest (a personal leaf, rows that differ only in the sign
    of a zero) as they are; the values are bitwise the same."""
    argv = BASE + ["--scaling", "local", "--personalize", "final_norm",
                   "--rounds", "1", "--ckpt", str(tmp_path)]
    train.main(argv)
    state, _ = ckpt.restore(str(tmp_path), train.setup(argv).state)
    assert all(t.stride(0) != 0 for _, t in tree_paths(state["params"]))
    shared = engine.share_replicas(state)
    _assert_same(shared, state)
    for entry in ("params", "mom"):
        for p, t in tree_paths(shared[entry]):
            assert (t.stride(0) == 0) == ("final_norm" not in p), (entry, p)
    signed = {"params": {"w": torch.tensor([[0.0, 1.0], [-0.0, 1.0]])},
              "mom": {"w": torch.ones(2, 3)}, "round": torch.tensor(1)}
    out = engine.share_replicas(signed)
    assert out["params"]["w"].stride(0) != 0
    assert out["mom"]["w"].stride(0) == 0
    assert out["round"] is signed["round"]


def test_train_driver_and_checkpoint_resume(tmp_path):
    args = BASE + ["--rounds", "2", "--ckpt", str(tmp_path),
                   "--ckpt-every", "1"]
    log1 = train.main(args)
    assert len(log1) == 2
    assert ckpt.latest_step(str(tmp_path)) == 2
    # resume: runs only the remaining round
    log2 = train.main(BASE + ["--rounds", "3", "--ckpt", str(tmp_path)])
    assert [r["round"] for r in log2] == [2]
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_resume_skips_rewriting_the_step_just_saved(tmp_path, monkeypatch):
    """--ckpt-every dividing --rounds writes the last step once."""
    steps = []
    save = ckpt.save
    monkeypatch.setattr(ckpt, "save", lambda d, s, st, keep=3: (
        steps.append(s), save(d, s, st, keep))[1])
    train.main(BASE + ["--rounds", "4", "--ckpt", str(tmp_path),
                       "--ckpt-every", "2"])
    assert steps == [2, 4]


# --------------------------------------------------------------------------- #
# configs: register, list_archs, param_count
# --------------------------------------------------------------------------- #

LM_100M = dict(name="lm-100m", family="dense", n_layers=12, d_model=768,
               n_heads=12, n_kv_heads=4, d_ff=3072, vocab_size=8192,
               qkv_bias=True, tie_embeddings=True)
LM_TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
               vocab_size=512)


@pytest.mark.parametrize("arch,reduced", [
    ("qwen2-0.5b", False), ("qwen2-0.5b", True), ("mamba2-1.3b", False),
    ("mamba2-1.3b", True), ("zamba2-2.7b", False), ("zamba2-2.7b", True),
    ("qwen3-4b", False), ("qwen3-4b-swa", False)])
def test_param_count_matches_reference(arch, reduced):
    assert configs.get_config(arch, reduced).param_count() == \
        jget_config(arch, reduced).param_count()


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
def test_register_and_param_count_of_the_examples_config(tiny, monkeypatch):
    cfg = configs.ModelConfig(**LM_100M)
    jcfg = JModelConfig(**LM_100M)
    if tiny:
        cfg, jcfg = cfg.replace(**LM_TINY), jcfg.replace(**LM_TINY)
    assert cfg.param_count() == jcfg.param_count()
    monkeypatch.setattr(configs, "_MODULE_FOR", dict(configs._MODULE_FOR))
    mod = types.ModuleType("repro_torch.configs.lm_100m")
    mod.CONFIG = mod.REDUCED = cfg
    monkeypatch.setitem(sys.modules, "repro_torch.configs.lm_100m", mod)
    configs.register("lm-100m", "lm_100m")
    assert "lm-100m" in configs.list_archs()
    assert configs.get_config("lm-100m") is cfg
    with pytest.raises(NotImplementedError, match="not ported"):
        configs.get_config("deepseek-v2-236b")


def test_param_count_refuses_unported_families():
    cfg = configs.get_config("qwen2-0.5b", True).replace(family="audio")
    with pytest.raises(NotImplementedError):
        cfg.param_count()


# --------------------------------------------------------------------------- #
# the train_lm runner against benchmarks/run.py's
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _reference_init():
    cfg = jget_config("qwen2-0.5b", reduced=True)
    from repro.models import ModelCallConfig as JCall
    from repro.models import build as jbuild
    return jax.device_get(jbuild(cfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))


def _train_lm_rows_match(method, rounds):
    from benchmarks.matrix import Point
    from benchmarks.run import TRAIN_LM_OVERRIDES, _run_train_lm, \
        _sum_train_lm
    assert train_lm.TRAIN_LM_OVERRIDES == TRAIN_LM_OVERRIDES
    fixed = dict(train_lm.FIXED, rounds=rounds)
    want, = _run_train_lm(Point({"method": method}, fixed, 0), {})
    init = _reference_init()
    got = train_lm.run_method(method, device="cpu",
                              init_params=lambda g: params_from_jax(
                                  init, g.device), rounds=rounds)
    assert got["coords"] == want["coords"]
    assert got["metrics"].keys() == want["metrics"].keys()
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["info"]["loss_curve"],
                               want["info"]["loss_curve"], rtol=1e-5,
                               atol=1e-4)
    assert got["metrics"]["sim_time_total"] == \
        want["metrics"]["sim_time_total"]
    assert got["info"]["loss_decreasing_trend"] == \
        want["info"]["loss_decreasing_trend"]
    for k in ("round_wall_s_mean", "tokens_per_s", "tokens_per_s_per_device"):
        assert got["metrics"][k] > 0
    gs, ws = train_lm.summary([got]), _sum_train_lm({"rows": [want]})
    assert [n for n, _ in gs] == [n for n, _ in ws]
    np.testing.assert_allclose(gs[0][1], ws[0][1], atol=2e-4)


@pytest.mark.parametrize("method", ["savic", "fedavg", "fedadagrad",
                                    "fedadam", "fedyogi"])
def test_train_lm_rows_match_the_bench(method):
    """The runner's row against ``benchmarks/run.py::_run_train_lm``'s,
    both from the reference's seed-0 weights, 2 rounds: losses to 1e-4
    absolute (the rows' 4 decimals)."""
    _train_lm_rows_match(method, 2)


def test_train_lm_local_adam_matches_the_bench_while_it_agrees():
    """local-adam over its first 5 rounds, at the same tolerances. Later
    rounds part from the reference's as the reference's own run parts from
    itself started one ulp away (``tests/_train_lm_ulp_reference.py``:
    3e-4 at round 5, 5.0e-3 at round 9): fp32 rounding amplified at
    gamma = 0.05, not a fault of the port."""
    _train_lm_rows_match("local-adam", 5)
