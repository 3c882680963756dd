"""The port's mesh layer on models (cases in ``tests/_torch_mesh_models.py``):
one spawn of 4 CPU gloo ranks for the file (``tests/_torch_mesh_worker.py
models``, a hard timeout), then each case held on one process.

* Reduced qwen2-0.5b, mamba2-1.3b and qwen2-moe-a2.7b under ``paper`` on
  (2, 2), the reference's ``test_sharded_equals_single_device`` archs:
  against the port's single-device round (on one thread, as each rank
  runs: CPU reductions sum in a thread-dependent order), every leaf to 1e-5 of its
  largest magnitude and the metrics to rtol 1e-5 (on this plan each rank
  runs its client's whole forward pass on the gathered params, so only the
  sync's sums and the norms change order); against the reference's round at
  the reference sharding worker's tolerances (loss 5e-3; params rtol 2e-3,
  atol 2e-4: the two packages' matmuls differ in their last bits, mamba2's
  scan sums in another order, and the MoE's routing may part on a near
  tie); fused against tree, bitwise.
* Serving reduced qwen2-0.5b's bf16 weights on (2, 2): the prefill's last
  logits and 6 greedy decode steps' logits against the port on one process
  (1e-5 of the largest logit, rtol 1e-5: each rank runs its two rows) and
  the first against the reference's; the greedy ids equal, or each first
  difference in a row a near tie (``kernels.ref.near_tie_check``).
* ``launch.train.main --mesh debug --mesh-shape 2x2`` against ``--mesh
  none --clients 2``: the logs' losses and drifts and the final state at
  the first bullet's tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_models as MM
from _torch_mesh_cases import (assert_metrics_close, assert_states_close,
                               one_thread, run_worker)
from repro.configs import get_config as jget_config
from repro.core import PrecondConfig as JPrecond
from repro.core import SavicConfig as JSavic
from repro.core import savic as jsavic
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ref
from repro_torch.launch import train


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jm = jbuild(jget_config(arch, reduced=True),
                JCall(dtype=jnp.float32, remat=False))
    return jax.device_get(jm.init(jax.random.PRNGKey(0)))


def _port_params(arch):
    return params_from_jax(_jax_init(arch), "cpu")


def _bf16(params):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(torch.bfloat16), params)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_models")
    inputs = {arch: _port_params(arch) for arch in MM.ARCHS}
    inputs["serve"] = _bf16(_port_params("qwen2-0.5b"))
    torch.save(inputs, d / "inputs.pt")
    return run_worker("models", d, timeout=420)


def _jax_rounds(arch):
    jm = jbuild(jget_config(arch, reduced=True),
                JCall(dtype=jnp.float32, remat=False))
    pc = JPrecond(kind="adam", alpha=1e-2)
    sv = JSavic(gamma=1e-3, beta1=0.9)
    step = jax.jit(jsavic.build_round_step(jm.loss, pc, sv))
    init = _jax_init(arch)
    state = jsavic.init_state(jax.random.PRNGKey(0), lambda k: jax.tree.map(
        jnp.asarray, init), pc, sv, MM.M)
    mets = []
    for nb in MM.batches(arch):
        state, met = step(state, jax.tree.map(jnp.asarray, nb),
                          jax.random.PRNGKey(0))
        mets.append(jax.device_get(met))
    return jax.device_get(state), mets


@pytest.mark.parametrize("arch", MM.ARCHS)
def test_sharded_equals_single_device(mesh_runs, arch):
    (st_t, met_t, meta_t), (st_f, met_f, meta_f) = mesh_runs[arch][False], \
        mesh_runs[arch][True]
    # the reference's meta keys; the fused build records its per-shard
    # layout over the model axis (2 shards)
    for meta in (meta_t, meta_f):
        assert {"mode", "method", "clients", "h_local", "b_client", "plan",
                "engine_spec"} <= set(meta["keys"])
    assert meta_t["flat"] is None and meta_f["flat"]["n_shards"] == 2
    assert meta_f["flat"]["axes"] == ["model"]
    assert_states_close(st_f, st_t, bitwise=True)
    for a, b in zip(met_f, met_t):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with one_thread():
        st_s, met_s = MM.single_round(arch, _port_params(arch), False)
    assert_states_close(st_t, st_s)
    assert_metrics_close(met_t, met_s)
    st_j, met_j = _jax_rounds(arch)
    for g, w in zip(met_t, met_j):
        assert abs(float(g["loss"]) - float(w["loss"])) < 5e-3
    for k in ("params", "mom"):
        assert_states_close(st_t[k], st_j[k], rtol=2e-3, atol_scale=0.0,
                            atol=2e-4)


def _hold_ids(got, want, logits, v_real):
    """Row by row while the ids agree; a first difference must be a near
    tie of ``logits`` (the comparison side's) at that step."""
    live = np.ones(got.shape[1], bool)
    for g in range(got.shape[0]):
        rows = np.flatnonzero(live)
        _, bad = ref.near_tie_check(torch.from_numpy(logits[g][rows]),
                                    torch.from_numpy(got[g, rows]),
                                    torch.from_numpy(want[g, rows]), v_real)
        assert bad == 0, g
        live &= got[g] == want[g]


def _close_logits(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_prefill_and_serve_steps_on_a_mesh(mesh_runs):
    lg_m, ids_m = mesh_runs["serve"]
    params = _bf16(_port_params("qwen2-0.5b"))
    with one_thread():
        lg_s, ids_s = MM.single_serve(params)
    v = jget_config("qwen2-0.5b", True).vocab_size
    _close_logits(lg_m[0], lg_s[0])
    _hold_ids(ids_m, ids_s, lg_s[:-1], v)
    live = (ids_m == ids_s).all(axis=0)
    for g in range(1, lg_m.shape[0]):
        _close_logits(lg_m[g][live], lg_s[g][live])
    # the reference's prefill logits from the same bf16 weights
    jm = jbuild(jget_config("qwen2-0.5b", reduced=True),
                JCall(dtype=jnp.float32))
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                      jax.device_get(_jax_init("qwen2-0.5b")))
    toks = jnp.asarray(MM.prompt()["tokens"].numpy().astype(np.int32))
    jlg, _ = jm.prefill_cache(jp, {"tokens": toks, "labels": toks}, MM.CACHE)
    _close_logits(lg_m[0], np.asarray(jlg, np.float32))
    _hold_ids(ids_m[:1], np.asarray(jnp.argmax(jlg[:, :v], -1))[None],
              np.asarray(jlg, np.float32)[None], v)


def test_train_main_on_a_mesh(mesh_runs):
    log_m, st_m = mesh_runs["train_main"]
    with one_thread():
        log_s, st_s = train.main(MM.TRAIN_ARGV + ["--clients", "2"],
                                 return_state=True)
    assert len(log_m) == len(log_s) == 2
    for a, b in zip(log_m, log_s):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["drift"], b["drift"], rtol=1e-4)
    assert_states_close(st_m, MM.to_numpy(st_s))


@pytest.mark.parametrize("name", list(MM.OBJECTIVE_CASES))
def test_train_main_objective_on_a_split_microbatch(mesh_runs, name):
    """An LM objective on ``plain`` (the client's microbatch split over the
    data axis, the ranks' labeled counts unequal) equals the single-device
    run's, ``--clients 1``: each rank's term is its share of the whole
    microbatch's objective."""
    log_m, st_m = mesh_runs["objective"][name]
    with one_thread():
        log_s, st_s = train.main(MM.OBJECTIVE_ARGV + MM.OBJECTIVE_CASES[name]
                                 + ["--clients", "1"], return_state=True)
    assert len(log_m) == len(log_s) == 2
    for a, b in zip(log_m, log_s):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["drift"], b["drift"], rtol=1e-4,
                                   atol=1e-12)
    assert_states_close(st_m, MM.to_numpy(st_s))


def _reference_template(name):
    """The reference's own engine state template for the case's run: its
    init_state's shapes and dtypes (``jax.eval_shape``)."""
    from repro.core import engine as jeng
    from repro.launch import train as jtrain
    M = 2 if name.startswith("paper") else 1
    jm = jbuild(jget_config("qwen2-0.5b", reduced=True),
                JCall(dtype=jnp.float32))
    args = jtrain._parser().parse_args(
        ["--arch", "qwen2-0.5b", "--clients", str(M)]
        + [f for f in MM.CKPT_CASES[name]
           if f not in ("--mode", "paper", "plain", "--use-fused-kernel")])
    jspec = jtrain._resolve_spec(args, M)[0]
    return jax.eval_shape(lambda k: jeng.init_state(k, jm.init, jspec, M),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(MM.CKPT_CASES))
def test_train_main_checkpoint_on_a_mesh(mesh_runs, name):
    """``--ckpt`` on the 2x2 mesh: the resume was bitwise in every rank
    (checked there); the written step is the port's own save of the
    gathered state byte for byte, and the resumed run writes the same
    step again; ``repro.checkpoint.restore`` reads it into the reference's
    state template with every shape and dtype, and every value the
    gathered state's."""
    from repro import checkpoint as jckpt
    from repro.utils.tree import tree_paths as jtree_paths
    from repro_torch.utils.tree import tree_paths
    r = mesh_runs["ckpt"][name]
    assert r["written_is_gathered"] and r["resumed_step_is_first"]
    assert len(r["log"]) == 2
    out, step = jckpt.restore(r["dir"], _reference_template(name))
    assert step == 2
    got, want = jtree_paths(out), tree_paths(r["state"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)
