"""The port's adaptive communication-budget controller
(``repro_torch.core.controller`` and its engine threading), held against the
reference (``repro.core.controller``, ``repro.core.engine``) and the numpy
oracle ``tests/_reference_controller.py``: the port's counterpart of
tests/test_controller.py.

Tolerances: every integer knob (t, H_t, H_m, b_eff), the kept fraction k
and the kept-entry counts exact; the port's float EMAs within 1 ulp of the
oracle replaying the port's own logged observations; rounds against the
reference as in tests/test_torch_hetero.py (state 1e-5 of its entry's
scale, metrics 1e-5 relative), the gradient-noise EMA also within 1e-6
absolute (gns = d2m/d2a − 1 cancels, so its error is the ratio's rounding,
a few ulps of 1). The reference's server m/v compression tests
are held in tests/test_torch_compression.py; its checkpoint round trip
waits for the port's checkpoint.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _reference_controller as ref_ctrl
from _torch_parity import (QUAD_KW, assert_quad_metrics, assert_state_close,
                           quad_batches, quad_losses, quad_port_state,
                           quad_run_jax, quad_run_port, quad_torch_batch)
from _torch_rng_replay import JaxStream
from repro.core import controller as JCTRL
from repro.core import engine as jeng
from repro_torch.core import controller as CTRL
from repro_torch.core import engine
from repro_torch.launch import train
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

STEP_TIMES = (1.0, 1.3, 2.0, 2.6)


def _pair(**kw):
    return JCTRL.ControllerSpec(**kw), CTRL.ControllerSpec(**kw)


def _specs(method, ctrl_kw, fused=False, **kw):
    jc, c = _pair(**ctrl_kw)
    return (jeng.method_spec(method, **QUAD_KW, controller=jc, **kw),
            engine.method_spec(method, **QUAD_KW, controller=c,
                               use_fused_kernel=fused, **kw))


def _obs(met):
    return {"delta_sq_mean": met["delta_sq_mean"].numpy(),
            "delta_sq_avg": met["delta_sq_avg"].numpy(),
            "payload_sq": met["payload_sq"].numpy(),
            "resid_sq": (met["compression_err"].numpy()
                         if "compression_err" in met else np.float32(0))}


# --------------------------------------------------------------------------- #
# the disabled controller is the identity
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", engine.METHODS)
def test_disabled_controller_is_the_plain_round(method):
    """``ControllerSpec()`` adds no state leaf and no metric and changes no
    number of the round."""
    spec = engine.method_spec(method, **QUAD_KW,
                              controller=CTRL.ControllerSpec())
    plain = engine.method_spec(method, **QUAD_KW)
    assert spec == plain and not spec.controller.enabled
    got, gmets = quad_run_port(spec)
    want, wmets = quad_run_port(plain)
    assert "ctrl" not in got and "ctrl_h_m" not in gmets[-1]
    for (k, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        assert torch.equal(a, b), k
    assert torch.equal(gmets[-1]["loss"], wmets[-1]["loss"])


# --------------------------------------------------------------------------- #
# controller_step against the oracle and the reference
# --------------------------------------------------------------------------- #

CTRL_SPECS = [
    dict(enabled=True, h_min=1, h_max=6, noise_target=0.5, k_min=0.1,
         resid_guard=0.4, step_times=STEP_TIMES),
    dict(enabled=True, h_min=2, h_max=8, noise_target=2.0, h_growth=2.0,
         ema=0.5, k_min=0.25, k_max=0.5, k_shrink=0.5, k_growth=2.0,
         buffer_max=3, spread_per_slot=0.8, step_times=(1.0, 1.7, 3.4, 4.2)),
    dict(enabled=True, h_min=1, h_max=4),            # homogeneous
]


def _assert_state_matches(tstate, nstate, msg):
    """Integer knobs and k bitwise; the EMAs within 1 ulp."""
    assert tstate.keys() == nstate.keys()
    for k, v in tstate.items():
        got, want = v.numpy(), np.asarray(nstate[k])
        assert got.dtype == want.dtype, (msg, k)
        if "ema" in k:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("si", range(len(CTRL_SPECS)))
def test_controller_step_matches_numpy_oracle(si):
    """40 steps of random observations (a fifth without a payload)."""
    spec = CTRL.ControllerSpec(**CTRL_SPECS[si])
    M = len(spec.step_times) or 4
    rng = np.random.default_rng(si)
    tstate = CTRL.init_ctrl_state(spec, M)
    nstate = ref_ctrl.init_ctrl_state(spec, M)
    _assert_state_matches(tstate, nstate, "init")
    for t in range(40):
        d2a = np.float32(rng.uniform(1e-4, 2.0))
        payload = np.float32(rng.uniform(0.0, 3.0)) \
            if rng.random() > 0.2 else np.float32(0.0)
        obs = {"delta_sq_mean": np.float32(d2a * rng.uniform(0.5, 4.0)),
               "delta_sq_avg": d2a, "payload_sq": payload,
               "resid_sq": np.float32(payload * rng.uniform(0.0, 0.9))}
        tstate, tknobs = CTRL.controller_step(
            spec, tstate, {k: torch.tensor(v) for k, v in obs.items()})
        nstate, nknobs = ref_ctrl.controller_step(spec, nstate, obs)
        _assert_state_matches(tstate, nstate, f"step {t}")
        for k in tknobs:
            np.testing.assert_array_equal(tknobs[k].numpy(), nknobs[k])


@pytest.mark.parametrize("si", range(len(CTRL_SPECS)))
def test_controller_tables_and_init_match_reference(si):
    """budget/growth tables, buffer depth and the initial state equal the
    reference's."""
    jspec, spec = _pair(**CTRL_SPECS[si])
    M = len(spec.step_times) or 4
    assert CTRL.budget_table(spec, M) == JCTRL.budget_table(jspec, M)
    assert CTRL.growth_table(spec) == JCTRL.growth_table(jspec)
    assert CTRL.buffer_depth(spec) == JCTRL.buffer_depth(jspec)
    want = jax.device_get(JCTRL.init_ctrl_state(jspec, M))
    got = CTRL.init_ctrl_state(spec, M)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert got[k].numpy().dtype == np.asarray(v).dtype, k


# --------------------------------------------------------------------------- #
# controlled rounds: against the reference, and replayed from the logs
# --------------------------------------------------------------------------- #

ROUNDS = {
    # GNS-driven H_t growth and the EF-guarded k schedule (fedadam, topk)
    "fedadam-topk-ef": dict(
        method="fedadam", ctrl=dict(enabled=True, h_min=1, h_max=5,
                                    noise_target=1e-3, resid_guard=0.3,
                                    k_min=0.1, step_times=STEP_TIMES),
        kw=dict(compression="topk", compression_k=0.5, error_feedback=True),
        H=6),
    # stragglers sit out (H_m = 0) behind a depth-3 FIFO, randk
    "fedavg-skip-randk": dict(
        method="fedavg", ctrl=dict(enabled=True, h_min=1, h_max=4,
                                   noise_target=0.05, buffer_max=3,
                                   step_times=STEP_TIMES),
        kw=dict(compression="randk", compression_k=0.5, async_buffer=3),
        H=4),
    # local D with the controller's H_m, no compression (payload 0)
    "local-adam-hm": dict(
        method="local-adam", ctrl=dict(enabled=True, h_min=1, h_max=3,
                                       noise_target=1e-3,
                                       step_times=STEP_TIMES),
        kw={}, H=3),
}


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("name", list(ROUNDS))
def test_controlled_round_matches_reference(name, fused):
    """Six controlled rounds: the realized knobs and logged observations
    equal the reference's (integers exactly), and so do state and metrics
    within the stated tolerances."""
    c = ROUNDS[name]
    jspec, spec = _specs(c["method"], c["ctrl"], fused, **c["kw"])
    init, want, wmets = quad_run_jax(jspec, rounds=6, H=c["H"])
    got, gmets = quad_run_port(spec, init, rounds=6, H=c["H"])
    assert_state_close(got, want)
    assert_quad_metrics(gmets, wmets)
    for g, w in zip(gmets, wmets):
        for k in ("ctrl_h_m", "ctrl_h_t", "ctrl_k", "ctrl_b_eff"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)
        for k in ("delta_sq_mean", "delta_sq_avg", "payload_sq"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       atol=1e-12, err_msg=k)
        # gns = d2m/d2a − 1 cancels: the packages' fp32 roundings of the
        # ratio (ulps of 1) set an absolute, not a relative, agreement
        np.testing.assert_allclose(float(g["ctrl_gns_ema"]),
                                   float(w["ctrl_gns_ema"]), rtol=1e-5,
                                   atol=1e-6)
    assert len({tuple(m["ctrl_h_m"].tolist()) for m in gmets}) > 1


@pytest.mark.parametrize("name", list(ROUNDS))
def test_trajectory_replayed_by_oracle_from_logs(name):
    """The numpy oracle reproduces the port's whole knob trajectory from the
    port's logged metrics alone: integer knobs and k exactly, gns_ema within
    1 ulp; every realized H_m obeys the budget rule for its round's H_t."""
    c = ROUNDS[name]
    spec = engine.method_spec(c["method"], **QUAD_KW,
                              controller=CTRL.ControllerSpec(**c["ctrl"]),
                              **c["kw"])
    _, mets = quad_run_port(spec, rounds=8, H=c["H"])
    ctrl = spec.controller
    s = ref_ctrl.init_ctrl_state(ctrl, 4)
    for r, met in enumerate(mets):
        np.testing.assert_array_equal(met["ctrl_h_m"].numpy(), s["h_m"],
                                      err_msg=f"round {r}")
        assert int(met["ctrl_h_t"]) == int(s["h_t"]), r
        np.testing.assert_array_equal(met["ctrl_k"].numpy(), s["k"])
        want_b = ref_ctrl.buffer_depth(ctrl) if ctrl.buffer_max else 0
        assert int(met["ctrl_b_eff"]) == want_b
        s, _ = ref_ctrl.controller_step(ctrl, s, _obs(met))
        np.testing.assert_array_max_ulp(met["ctrl_gns_ema"].numpy(),
                                        s["gns_ema"], maxulp=1)
        np.testing.assert_array_equal(
            met["ctrl_h_m"].numpy(),
            ref_ctrl.budget_h(ctrl, int(met["ctrl_h_t"]), 4))
    assert int(mets[-1]["ctrl_h_t"]) > ctrl.h_min, "H_t never grew"


def test_straggler_skip_with_buffer():
    """With a FIFO the budget rule drops its floor of 1: at H_t = 1 the slow
    clients sit out (H_m = 0) and report their round-start loss, the
    applied delta is rescaled to the active subset, b_eff = half_up(2.6)."""
    c = ROUNDS["fedavg-skip-randk"]
    spec = engine.method_spec(c["method"], **QUAD_KW,
                              controller=CTRL.ControllerSpec(**c["ctrl"]),
                              **c["kw"])
    state, mets = quad_run_port(spec, rounds=6, H=4)
    np.testing.assert_array_equal(mets[0]["ctrl_h_m"].numpy(), [1, 0, 0, 0])
    assert int(mets[0]["ctrl_b_eff"]) == 3
    assert all(np.isfinite(float(m["loss"])) for m in mets)
    assert torch.isfinite(state["params"]["x"]).all()
    # an idle client's reported loss is its loss at the round's start
    (nb, _), = quad_batches(1, 4)
    x0 = torch.zeros(24)
    for m in (1, 2, 3):
        want = quad_losses()[1]({"x": x0}, {"z": torch.from_numpy(
            nb["z"][m, 0])})
        np.testing.assert_allclose(float(mets[0]["loss_per_client"][m]),
                                   float(want), rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
def test_frozen_controller_equals_static_spec(fused):
    """h_min = h_max and k_min = k_max (binary-exact 0.25) freeze every knob
    at the static values: bitwise the static spec's rounds."""
    comp = engine.CompressionSpec(op="topk", k=0.25, error_feedback=True)
    ctrl = CTRL.ControllerSpec(enabled=True, h_min=3, h_max=3, k_min=0.25,
                               k_max=0.25)
    st_d, _ = quad_run_port(engine.method_spec(
        "savic", **QUAD_KW, compression=comp, controller=ctrl,
        use_fused_kernel=fused))
    st_s, _ = quad_run_port(engine.method_spec(
        "savic", **QUAD_KW, compression=comp, use_fused_kernel=fused))
    for grp in ("params", "mom", "ef"):
        assert torch.equal(st_d[grp]["x"], st_s[grp]["x"]), grp
    np.testing.assert_array_equal(st_d["ctrl"]["h_m"].numpy(), [3] * 4)
    assert float(st_d["ctrl"]["k"]) == 0.25


@pytest.mark.parametrize("op", ["topk", "randk"])
def test_kept_count_matches_reference(op):
    """The controller's kept fraction (an fp32 k, rounded half up in fp32):
    the same entries kept as the reference's traced count, bitwise, for
    fractions that are and are not binary-exact, on rows of every size."""
    rng = np.random.default_rng(0)
    for n in (1, 3, 10, 24, 1000, 4099):
        x = rng.standard_normal((4, n)).astype(np.float32)
        for k in (0.05, 0.1, 0.25, 0.3, 0.512, 0.8, 1.0):
            kf = np.float32(k)
            for ef in (False, True):
                spec_j = jeng.CompressionSpec(op=op, k=0.5,
                                              error_feedback=ef)
                spec_t = engine.CompressionSpec(op=op, k=0.5,
                                                error_feedback=ef)
                key = jax.random.PRNGKey(n)
                want = np.asarray(jeng._compress_leaf(
                    spec_j, jnp.asarray(x), key, k_frac=jnp.float32(kf)))
                got = engine._compress_leaf(
                    spec_t, torch.from_numpy(x), JaxStream(key),
                    k_frac=float(kf)).numpy()
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{n} {k} {ef}")
                kc = engine._kept_count(spec_t, n, float(kf))[0]
                assert ((got != 0).sum(axis=1) == kc).all()


# --------------------------------------------------------------------------- #
# validation, conflicts and the budget rule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bad", [
    dict(h_min=0), dict(h_min=5, h_max=4), dict(ema=1.0), dict(ema=0.0),
    dict(k_min=0.0), dict(k_min=0.6, k_max=0.5), dict(k_max=1.5),
    dict(k_shrink=0.0), dict(k_growth=0.5), dict(h_growth=1.0),
    dict(resid_guard=0.0), dict(spread_per_slot=0.0), dict(buffer_max=-1),
    dict(step_times=(1.0, -2.0))])
def test_controller_spec_validation(bad):
    with pytest.raises(ValueError):
        CTRL.ControllerSpec(enabled=True, **bad)


def test_engine_spec_takes_only_a_controller_spec():
    with pytest.raises(ValueError):
        engine.EngineSpec(controller="yes")


@pytest.mark.parametrize("kw,match", [
    (dict(local_steps=(1, 2, 2, 1)), "local_steps"),
    (dict(participation=0.5), "participation"),
    (dict(asynchrony=engine.AsyncSpec(buffer_rounds=2), buffer_max=4),
     "buffer_max"),
])
def test_build_time_conflicts_raise(kw, match):
    """The controller owns H_m; its noise estimate needs every client; b_eff
    masks within the allocated FIFO. Each conflict is a build-time
    ValueError, as in the reference."""
    kw = dict(kw)
    ctrl = CTRL.ControllerSpec(enabled=True, h_max=2,
                               buffer_max=kw.pop("buffer_max", 0))
    with pytest.raises(ValueError, match=match):
        engine.build_round_step(quad_losses()[1], engine.method_spec(
            "fedavg", controller=ctrl, **kw))


def test_h_max_beyond_the_round_raises():
    spec = engine.method_spec("fedavg", controller=CTRL.ControllerSpec(
        enabled=True, h_max=8))
    (nb, k), = quad_batches(1, 3)
    with pytest.raises(ValueError, match="h_max"):
        engine.build_round_step(quad_losses()[1], spec)(
            quad_port_state(spec), quad_torch_batch(nb), JaxStream(k))


def test_budget_rule_units():
    sp = CTRL.ControllerSpec(enabled=True, h_max=8,
                             step_times=(1.0, 2.0, 8.0))
    spb = dataclasses.replace(sp, buffer_max=2)
    sph = CTRL.ControllerSpec(enabled=True, h_max=8)
    for s, h, n, want in ((sp, 4, 3, [4, 2, 1]), (spb, 4, 3, [4, 2, 0]),
                          (sph, 3, 4, [3, 3, 3, 3])):
        got = CTRL.budget_h(s, h, n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), ref_ctrl.budget_h(s, h, n))
        np.testing.assert_array_equal(
            CTRL.budget_h(s, torch.tensor(h, dtype=torch.int32), n).numpy(),
            want)
    with pytest.raises(ValueError, match="step_times"):
        CTRL.budget_h(sp, 4, 5)


def test_buffer_depth_and_half_up():
    assert CTRL.half_up(2.5) == 3 and round(2.5) == 2
    assert CTRL.half_up(0.5) == 1 and CTRL.half_up(1.49) == 1
    mk = lambda **kw: CTRL.ControllerSpec(enabled=True, **kw)
    assert CTRL.buffer_depth(mk(buffer_max=0)) == 1
    assert CTRL.buffer_depth(mk(buffer_max=4)) == 1
    assert CTRL.buffer_depth(mk(buffer_max=4, step_times=(1.0, 2.5))) == 3
    assert CTRL.buffer_depth(mk(buffer_max=2, step_times=(1.0, 9.0))) == 2
    assert CTRL.buffer_depth(mk(buffer_max=4, step_times=(1.0, 2.0),
                                spread_per_slot=0.5)) == 4


def test_k_schedule_freezes_without_payload():
    """No compression: payload 0, so k and resid_ema never move."""
    sp = CTRL.ControllerSpec(enabled=True, h_max=4, k_min=0.1)
    s = CTRL.init_ctrl_state(sp, 4)
    obs = {"delta_sq_mean": torch.tensor(3.0), "delta_sq_avg":
           torch.tensor(1.0), "payload_sq": torch.tensor(0.0),
           "resid_sq": torch.tensor(0.0)}
    for _ in range(5):
        s, _ = CTRL.controller_step(sp, s, obs)
        assert float(s["k"]) == 1.0 and float(s["resid_ema"]) == 0.0


def test_train_records_replay_through_the_oracle():
    """``launch/train.py``'s records under --controller carry the round's
    observations exactly: the numpy oracle replays H_m, H_t, b_eff and k
    from them (what chip_smoke.py's full-width controller phase checks)."""
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--rounds", "3", "--h-local", "4", "--clients", "4", "--batch",
            "1", "--seq", "8", "--controller", "--async-buffer", "2",
            "--het-model", "lognormal", "--compression", "topk",
            "--compression-k", "0.1", "--error-feedback",
            "--use-fused-kernel", "--ctrl-noise-target", "1e-3"]
    log = train.main(argv)
    ctrl = train._resolve_spec(train._parser().parse_args(argv), 4)[0] \
        .controller
    s = ref_ctrl.init_ctrl_state(ctrl, 4)
    for rec in log:
        assert rec["ctrl_h_m"] == s["h_m"].tolist()
        assert (rec["ctrl_h_t"], rec["ctrl_b_eff"]) == (int(s["h_t"]),
                                                        int(s["b_eff"]))
        assert rec["ctrl_k"] == round(float(s["k"]), 6)
        s, _ = ref_ctrl.controller_step(ctrl, s, {
            "delta_sq_mean": rec["delta_sq_mean"],
            "delta_sq_avg": rec["delta_sq_avg"],
            "payload_sq": rec["payload_sq"],
            "resid_sq": rec["compression_err"]})
        assert rec["ctrl_gns_ema"] == round(float(s["gns_ema"]), 6)
    assert 0 in log[0]["ctrl_h_m"] and log[-1]["ctrl_h_t"] > 1
