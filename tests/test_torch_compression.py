"""The port's sync compression held against the reference (DESIGN.md §4):
kernel K3's plain version, ``compress_tree`` for every operator, the wire
accounting, the server m/v sync compression, and whole compressed rounds
against the live JAX engine on the reference's replayed draws.

Tolerances:
  * K3's plain version against the reference's jnp oracle and its Pallas
    kernel (interpret mode) on the same inputs: q exactly, dec bitwise;
  * ``compress_tree`` and the server m/v compression on the same inputs and
    draws: bitwise (topk/randk select with a stable ranking, ties to the
    lower index, as ``lax.top_k`` does);
  * wire bytes: exactly;
  * whole rounds: as tests/test_torch_engine.py (1e-5 of the state entry's
    scale, loss 1e-5 relative); the EF residual, like the server's m, at
    1e-5 of the matching params leaf's scale; int8 rounds allow the rare
    boundary flips that ``_torch_parity.assert_state_close`` describes; and
    ``compression_err`` 1e-3 relative (XLA's CPU ``vdot`` sums in fp32
    sequentially).

The CUDA kernel itself is held against its plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_metrics_close, assert_state_close, models,
                           run_jax, run_port)
from _torch_rng_replay import JaxStream
from repro.core import engine as jeng
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.core import engine
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize_update as qu
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

KW = dict(gamma=3e-3, eta_l=3e-3)


# --------------------------------------------------------------------------- #
# K3: stochastic int8 quantize-dequantize
# --------------------------------------------------------------------------- #


def _qdq_inputs(M, n, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, n)) * rng.uniform(1e-3, 10.0, (M, 1))
         ).astype(np.float32)
    for r in zero_rows:
        x[r] = 0.0
    u = rng.uniform(size=(M, n)).astype(np.float32)
    scale = (np.abs(x).max(axis=1) / np.float32(127.0)).astype(np.float32)
    return x, u, scale


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("M,n,zero_rows", [
    (1, 1, ()), (1, 1000, ()), (3, 1001, (1,)), (4, 16387, (0, 3)),
    (2, 4096, (0, 1)),
])
def test_quantize_update_plain_matches_reference(M, n, zero_rows):
    """Same x, u, per-row scale: q equal and dec bitwise equal to the
    reference's jnp oracle and to its Pallas kernel in interpret mode, zero
    scales (all-zero rows) included."""
    x, u, scale = _qdq_inputs(M, n, seed=M * n, zero_rows=zero_rows)
    q, dec = ops.quantize_update(torch.from_numpy(x), torch.from_numpy(u),
                                 torch.from_numpy(scale))
    assert q.dtype == torch.int8 and dec.dtype == torch.float32
    jq, jdec = jref.quantize_update_ref(x, u, scale[:, None])
    kq, kdec = jops.quantize_update(jnp.asarray(x), jnp.asarray(u),
                                    jnp.asarray(scale[:, None]))
    for wq, wdec in ((jq, jdec), (kq, kdec)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(_bits(dec.numpy()), _bits(wdec))
    for r in zero_rows:
        assert not q[r].any() and not _bits(dec[r].numpy()).any()
    assert int(q.abs().max()) <= 127


def test_quantize_update_hits_the_int8_ends():
    """Rows scaled to their absmax reach ±127 exactly, never past."""
    x = np.array([[-2.0, 2.0, 1.0, 0.0]], np.float32)
    u = np.array([[0.0, 0.999999, 0.5, 0.25]], np.float32)
    scale = np.array([2.0 / 127.0], np.float32)
    q, dec = ref.quantize_update_ref(torch.from_numpy(x),
                                     torch.from_numpy(u),
                                     torch.from_numpy(scale))
    jq, jdec = jref.quantize_update_ref(x, u, scale[:, None])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(dec.numpy()), _bits(jdec))
    assert q[0, 0] == -127 and q[0, 1] == 127


@pytest.mark.parametrize("bad", [
    lambda x, u, s: (x[0], u, s),                       # not (M, n)
    lambda x, u, s: (x, u[:, :-1], s),                  # u shape
    lambda x, u, s: (x, u, s[:1]),                      # scale shape
    lambda x, u, s: (x.double(), u, s),                 # dtype
    lambda x, u, s: (x.t().contiguous().t(), u, s),     # not contiguous
])
def test_quantize_update_checks_its_arguments(bad):
    x, u, s = (torch.from_numpy(a) for a in _qdq_inputs(3, 8, seed=0))
    with pytest.raises(ValueError):
        ops.quantize_update(*bad(x, u, s))


def test_quantize_update_kernel_refuses_cpu_tensors():
    x, u, s = (torch.from_numpy(a) for a in _qdq_inputs(2, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        qu.quantize_update_flat(x, u, s)
    assert qu.quantize_update_flat.launches == 0


# --------------------------------------------------------------------------- #
# compress_tree and the wire accounting
# --------------------------------------------------------------------------- #


def _deltas(M=3, seed=0):
    """A tree with tied magnitudes (a), a continuous leaf (b) and an all-zero
    leaf (c: all ties, zero int8 scale)."""
    rng = np.random.default_rng(seed)
    return {"a": (rng.integers(-3, 4, size=(M, 7, 5)) * 0.5
                  ).astype(np.float32),
            "b": {"w": rng.normal(size=(M, 33)).astype(np.float32)},
            "c": np.zeros((M, 4), np.float32)}


OPS = [("topk", 0.25), ("topk", 0.5), ("randk", 0.3), ("int8-stochastic", 1.0)]


@pytest.mark.parametrize("ef", [False, True], ids=["no-ef", "ef"])
@pytest.mark.parametrize("op,k", OPS, ids=[f"{o}-{k}" for o, k in OPS])
def test_compress_tree_matches_reference(op, k, ef):
    deltas = _deltas()
    key = jax.random.PRNGKey(7)
    jspec = jeng.CompressionSpec(op=op, k=k, error_feedback=ef)
    want = jeng.compress_tree(jspec, jax.tree.map(jnp.asarray, deltas), key)
    for fused in (False, True):
        spec = engine.CompressionSpec(op=op, k=k, error_feedback=ef,
                                      use_fused_kernel=fused)
        got = engine.compress_tree(
            spec, {"a": torch.from_numpy(deltas["a"]),
                   "b": {"w": torch.from_numpy(deltas["b"]["w"])},
                   "c": torch.from_numpy(deltas["c"])}, JaxStream(key))
        wd = {p: np.asarray(v) for p, v in jtree_paths(want)}
        for path, g in tree_paths(got):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(wd[path]),
                                          err_msg=path)
        if op == "topk":
            # exactly k·n entries per client row, even on the all-tie leaf
            kc = engine._k_count(k, 35)
            assert (got["a"].reshape(3, -1) != 0).sum(1).max() <= kc


def test_topk_ties_keep_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -3.0]])
    got = engine.compress_tree(engine.CompressionSpec(op="topk", k=0.5),
                               {"x": x}, JaxStream(jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(got["x"].numpy(),
                                  [[0.0, 3.0, 3.0, 0.0, 3.0, 0.0]])


@pytest.mark.parametrize("op,k", OPS + [("none", 1.0)],
                         ids=[f"{o}-{k}" for o, k in OPS] + ["none"])
def test_measured_wire_bytes_equal_bytes_on_wire(op, k):
    """The payload measured from what compress_tree emitted equals the
    analytic per-client accounting, which equals the reference's."""
    rng = np.random.default_rng(3)
    shapes = {"w": (17, 6), "b": (5,), "e": (40, 3)}
    M = 3
    deltas = {n: torch.from_numpy(rng.normal(size=(M,) + s)
                                  .astype(np.float32))
              for n, s in shapes.items()}
    params = {n: torch.zeros(s) for n, s in shapes.items()}
    spec = engine.method_spec("savic", compression=op, compression_k=k)
    comp = spec.sync.compression
    c = deltas if comp.is_identity() else engine.compress_tree(
        comp, deltas, JaxStream(jax.random.PRNGKey(1)))
    measured = engine.measured_wire_bytes(comp, c)
    analytic = engine.bytes_on_wire(spec, params)
    assert measured.shape == (M,)
    assert (measured == analytic["delta_bytes"]).all()
    jspec = jeng.method_spec("savic", compression=op, compression_k=k)
    assert analytic == jeng.bytes_on_wire(
        jspec, {n: jnp.zeros(s) for n, s in shapes.items()})


@pytest.mark.parametrize("method,extra", [
    ("fedadam", dict(server_sync_k=0.25, server_sync_dtype="bfloat16")),
    ("local-adam", dict(compression="int8-stochastic", sync_dtype="bfloat16")),
    ("savic", dict(sync_dtype="float16")),
])
def test_bytes_on_wire_matches_reference(method, extra):
    _, jm, tm = models()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = {k: v for k, v in tree_paths(
        tm.init(torch.Generator().manual_seed(0)))}
    got = engine.bytes_on_wire(engine.method_spec(method, **extra), params)
    assert got == jeng.bytes_on_wire(jeng.method_spec(method, **extra), jp)


def test_server_state_compression_matches_reference():
    """Shared top-|m| index set (ties to the lower index), v floor at v_init,
    then the sync-dtype round trip: bitwise."""
    rng = np.random.default_rng(2)
    m = {"a": (rng.integers(-2, 3, size=(6, 4)) * 0.25).astype(np.float32),
         "b": rng.normal(size=(9,)).astype(np.float32)}
    v = {"a": rng.uniform(size=(6, 4)).astype(np.float32),
         "b": rng.uniform(size=(9,)).astype(np.float32)}
    for kw in (dict(sync_k=0.3), dict(sync_dtype="bfloat16"),
               dict(sync_k=0.5, sync_dtype="float16", v_init=1e-4)):
        jsv = jeng.ServerSpec(kind="adaptive", **kw)
        sv = engine.ServerSpec(kind="adaptive", **kw)
        jm_, jv = jeng._compress_server_state(
            jsv, jax.tree.map(jnp.asarray, m), jax.tree.map(jnp.asarray, v))
        tm_, tv = engine._compress_server_state(
            sv, {k: torch.from_numpy(a) for k, a in m.items()},
            {k: torch.from_numpy(a) for k, a in v.items()})
        for k in m:
            np.testing.assert_array_equal(_bits(tm_[k].numpy()),
                                          _bits(jm_[k]))
            np.testing.assert_array_equal(_bits(tv[k].numpy()), _bits(jv[k]))


# --------------------------------------------------------------------------- #
# Whole compressed rounds against the live reference engine
# --------------------------------------------------------------------------- #

COMPRESSED = {
    "savic-int8-ef": ("savic", dict(compression="int8-stochastic",
                                    error_feedback=True)),
    "savic-int8": ("savic", dict(compression="int8-stochastic")),
    "savic-topk": ("savic", dict(compression="topk", compression_k=0.25)),
    "savic-randk-ef": ("savic", dict(compression="randk",
                                     compression_k=0.25,
                                     error_feedback=True)),
    "fedavg-randk": ("fedavg", dict(compression="randk",
                                    compression_k=0.25)),
    "local-adam-topk-ef": ("local-adam", dict(compression="topk",
                                              compression_k=0.25,
                                              error_feedback=True)),
    "fedadam-server-sync": ("fedadam", dict(server_sync_k=0.5,
                                            server_sync_dtype="bfloat16")),
}


@functools.lru_cache(maxsize=None)
def _jax_compressed(name, fused=False):
    method, extra = COMPRESSED[name]
    return run_jax(jeng.method_spec(method, use_fused_kernel=fused, **KW,
                                    **extra))


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("name", list(COMPRESSED))
def test_compressed_round_matches_reference(name, fused):
    """Two rounds, reference tree path (jnp QDQ) against the port's tree
    loop (plain QDQ) and fused loop (K1 and K3 wrappers), including the EF
    residual state and compression_err."""
    method, extra = COMPRESSED[name]
    init, want, wmets = _jax_compressed(name)
    spec = engine.method_spec(method, use_fused_kernel=fused, **KW, **extra)
    got, gmets = run_port(spec, init)
    assert_state_close(got, want, flips="int8" in name)
    assert_metrics_close(gmets, wmets)
    if "compression_err" in gmets[0]:
        for met in gmets:
            assert met["wire_bytes"].shape == (2,)


def test_int8_round_matches_reference_fused_path():
    """Port fused loop (plain versions on the CPU) against the reference's
    fused loop (K1 and K3 as Pallas kernels in interpret mode)."""
    init, want, wmets = _jax_compressed("savic-int8-ef", fused=True)
    method, extra = COMPRESSED["savic-int8-ef"]
    got, gmets = run_port(engine.method_spec(method, use_fused_kernel=True,
                                             **KW, **extra), init)
    assert_state_close(got, want, flips=True)
    assert_metrics_close(gmets, wmets)
