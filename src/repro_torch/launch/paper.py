"""The paper's experiments on the port (counterpart of the ``fig1``,
``thm1``, ``thm2`` and ``sec52`` runners of ``benchmarks/run.py`` and of
``examples/quickstart.py``'s loop), through ``core/savic.py`` and
``core/engine.py``, with the reference runners' constants:

  fig1   Fig. 1: the MLP (``models/mlp.py``) on 8000 synthetic CIFAR-shaped
         examples (1000 held out) split over 10 clients by the main-class
         protocol (main_frac 0.3 / 0.5 / 0.7); SGD, Adam and OASIS under
         global and local scaling (``FIG1_METHODS``); 25 rounds of H = 6
         local steps, b = 64, γ = 0.002, β₁ = 0.9, α = 1e-2.
  thm1   Theorem 1's shape on identical-data quadratics (d = 24, M = 8):
         the noise ball against γ and against M, the transient rate.
  thm2   Theorem 2 on heterogeneous quadratics: the ball against H, and the
         bound checked on an f-gap proxy.
  sec52  §5.2's critique of FedAdaGrad's v₋₁: the mean server step norm
         over v_init ∈ {1, τ²} × τ ∈ {0.1, 1e-3, 1e-5}.

Round r of a run draws from ``streams(r)``, by default
``TorchStream(seed + 1).fold(r)`` (``utils/rng.py``); the tests pass streams
that replay the reference's keys. Every row has the reference's bench row
shape, ``{"coords": {...}, "metrics": {...}}``, so ``summary`` gives the
names the reference's ``_sum_fig1`` / ``_sum_thm1`` / ``_sum_thm2`` /
``_sum_sec52`` give. The CLI prints one JSON row per line, then one JSON
summary per experiment; it writes no file.

``--seed`` sets fig1's data, split, init and round streams; the quadratic
runners keep the reference's fixed seeds. ``--rounds`` overrides fig1's 25
and sec52's 5 rounds; a theorem experiment's round count is part of it.

  PYTHONPATH=src python -m repro_torch.launch.paper --exp fig1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.paper --exp fig1 \
      --use-fused-kernel                          # --device cuda, the default
  PYTHONPATH=src python -m repro_torch.launch.paper --exp thm1 \
      --experiment transient
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import PrecondConfig, SavicConfig, engine, savic, theory
from repro_torch.data import (ClassificationData, FederatedLoader,
                              QuadraticLoader, QuadraticProblem,
                              main_class_partition)
from repro_torch.models import mlp
from repro_torch.utils import rng
from repro_torch.utils.device import resolve_device

EXPERIMENTS = ("fig1", "thm1", "thm2", "sec52")
FIG1_METHODS = {
    "SGD": ("identity", "global"),
    "Adam global": ("adam", "global"),
    "Adam local": ("adam", "local"),
    "OASIS global": ("oasis", "global"),
    "OASIS local": ("oasis", "local"),
}
MAIN_FRACS = (0.3, 0.5, 0.7)
FIG1 = dict(n=8000, ntest=1000, clients=10, rounds=25, h_local=6, batch=64,
            gamma=0.002, beta1=0.9, alpha=1e-2)
THM1_EXPERIMENTS = ("ball_vs_gamma", "ball_vs_M", "transient")
THM2_EXPERIMENTS = ("ball_vs_H", "bound")
SEC52_POINTS = tuple((v, tau) for v in ("one", "tau2")
                     for tau in (0.1, 0.001, 1e-5))
SEC52 = dict(rounds=5, h_local=5, clients=4)


def _row(coords, metrics):
    return {"coords": dict(coords), "metrics": dict(metrics)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(nb, device):
    """A numpy round batch as tensors: integer leaves int64, float fp32."""
    return {k: torch.from_numpy(v).to(
        device, torch.long if v.dtype.kind in "iu" else torch.float32)
        for k, v in nb.items()}


def default_streams(seed):
    """Round r's stream: ``TorchStream(seed + 1).fold(r)``."""
    return rng.TorchStream(seed + 1).fold


# --------------------------------------------------------------------------- #
# fig1
# --------------------------------------------------------------------------- #


def fig1_data(seed=0):
    return ClassificationData.make(n=FIG1["n"], n_classes=10, seed=seed)


def fig1_setup(main_frac, method, *, device, seed=0, data=None,
               ntest=FIG1["ntest"], parts=None, use_fused_kernel=False,
               init_params=None):
    """What a Fig. 1 run of one (main_frac, method) point needs: ``(step,
    state, loader, xte, yte)``, the round step, the initial engine state, the
    training examples' loader and the held-out examples on ``device``.
    ``parts`` (the client split of the training examples) and
    ``init_params(generator)`` replace the run's own."""
    device = torch.device(device)
    data = data if data is not None else fig1_data(seed)
    ytr = data.y[:-ntest]
    if parts is None:
        parts = main_class_partition(ytr, FIG1["clients"], main_frac,
                                     seed=seed)
    kind, scaling = FIG1_METHODS[method]
    pc = PrecondConfig(kind=kind, alpha=FIG1["alpha"])
    sv = SavicConfig(gamma=FIG1["gamma"], beta1=FIG1["beta1"],
                     scaling=scaling, use_fused_kernel=use_fused_kernel)
    spec = savic.engine_spec(pc, sv)
    step = engine.build_round_step(mlp.loss, spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = engine.init_state(gen, init_params or mlp.init, spec, len(parts))
    loader = FederatedLoader(data.x[:-ntest], ytr.astype(np.int32), parts,
                             batch_size=FIG1["batch"], seed=seed)
    xte = torch.from_numpy(data.x[-ntest:]).to(device)
    yte = torch.from_numpy(data.y[-ntest:].astype(np.int64)).to(device)
    return step, state, loader, xte, yte


def fig1_run(main_frac, method, *, device, seed=0, rounds=FIG1["rounds"],
             h_local=FIG1["h_local"], streams=None, **setup_kw):
    """One (main_frac, method) point of Fig. 1: the per-round rows (loss,
    the averaged model's test accuracy, the round's wall time between
    device synchronizations). ``setup_kw`` go to ``fig1_setup``."""
    device = torch.device(device)
    step, state, loader, xte, yte = fig1_setup(main_frac, method,
                                               device=device, seed=seed,
                                               **setup_kw)
    streams = streams or default_streams(seed)
    rows = []
    for r in range(rounds):
        nb = to_device(loader.round_batch(h_local), device)
        _sync(device)
        t0 = time.perf_counter()
        state, met = step(state, nb, streams(r))
        loss = float(met["loss"])                 # waits for the round
        wall = time.perf_counter() - t0
        acc = mlp.acc(engine.average_params(state), xte, yte)
        rows.append(_row({"main_frac": main_frac, "method": method,
                          "round": r},
                         {"loss": loss, "test_acc": acc, "wall_s": wall}))
    return rows


# --------------------------------------------------------------------------- #
# the quadratics: thm1, thm2, sec52
# --------------------------------------------------------------------------- #


def _quad_tensors(problem, device):
    return (torch.as_tensor(problem.Q, dtype=torch.float32, device=device),
            torch.as_tensor(problem.b, dtype=torch.float32, device=device))


def quad_run(problem, gamma, H, rounds, *, device, kind="identity",
             alpha=1e-8, seed=0, use_fused_kernel=False, streams=None):
    """SAVIC (β₁ = 0) on ``problem`` from x = 0: ‖x̂ − x*‖² after each
    round, as a numpy array (the reference's ``_quad_runner``)."""
    device = torch.device(device)
    Q, b = _quad_tensors(problem, device)

    def loss(params, micro):
        x = params["x"]
        Qm, bm = Q[micro["cid"]], b[micro["cid"]]
        return 0.5 * (x - bm) @ Qm @ (x - bm) + micro["z"] @ x

    pc = PrecondConfig(kind=kind, alpha=alpha)
    sv = SavicConfig(gamma=gamma, beta1=0.0, use_fused_kernel=use_fused_kernel)
    step = savic.build_round_step(loss, pc, sv)
    M, d = problem.b.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    state = savic.init_state(gen, lambda g: {"x": torch.zeros(d,
                                                              device=device)},
                             pc, sv, M)
    loader = QuadraticLoader(problem, seed=seed)
    streams = streams or default_streams(seed)
    xstar = torch.as_tensor(problem.x_star(), dtype=torch.float32,
                            device=device)
    dists = []
    for r in range(rounds):
        state, _ = step(state, to_device(loader.round_batch(H), device),
                        streams(r))
        x = savic.average_params(state)["x"]
        dists.append(float(torch.sum((x - xstar) ** 2)))
    return np.asarray(dists)


def thm1_rows(experiment, *, device, use_fused_kernel=False):
    """The reference's ``_run_thm1`` rows of one experiment."""
    kw = dict(device=device, use_fused_kernel=use_fused_kernel)
    prob = QuadraticProblem.make(d=24, M=8, mu=0.5, L=4.0, sigma=0.6, seed=1)
    coords = {"experiment": experiment}
    rows = []
    if experiment == "ball_vs_gamma":
        for gamma in (0.02, 0.04, 0.08):
            tail = float(np.mean([quad_run(prob, gamma, 4, 120, seed=s,
                                           **kw)[-10:].mean()
                                  for s in range(3)]))
            rows.append(_row({**coords, "case": f"gamma{gamma}"},
                             {"gamma": gamma, "H": 4, "M": 8, "value": tail}))
    elif experiment == "ball_vs_M":
        for M in (2, 8):
            p = QuadraticProblem.make(d=24, M=M, mu=0.5, L=4.0, sigma=0.6,
                                      seed=1)
            tail = float(np.mean([quad_run(p, 0.06, 4, 120, seed=s,
                                           **kw)[-10:].mean()
                                  for s in range(3)]))
            rows.append(_row({**coords, "case": f"M{M}"},
                             {"gamma": 0.06, "H": 4, "M": M, "value": tail}))
    elif experiment == "transient":
        d = quad_run(prob, 0.05, 4, 40, seed=0, **kw)
        spec = theory.ProblemSpec(mu=0.5, L=4.0, sigma2=0.36, alpha=1,
                                  Gamma=1, M=8, H=4)
        pred = theory.thm1_rate(spec, 0.05) ** 4
        meas = (d[9] / d[0]) ** (1 / 9)
        rows.append(_row({**coords, "case": "rate"},
                         {"transient_rate_measured": round(float(meas), 4),
                          "transient_rate_bound_per_round":
                              round(float(pred), 4)}))
    else:
        raise ValueError(f"thm1 experiment {experiment!r}; expected one of "
                         f"{THM1_EXPERIMENTS}")
    return rows


def thm2_rows(experiment, *, device, use_fused_kernel=False, balls=None):
    """The reference's ``_run_thm2`` rows of one experiment; ``balls``
    (H -> ball) is shared between the two experiments, as the reference
    shares it through its context."""
    kw = dict(device=device, use_fused_kernel=use_fused_kernel)
    prob = QuadraticProblem.make(d=24, M=8, mu=0.5, L=4.0, sigma=0.2,
                                 heterogeneity=6.0, seed=2)
    balls = {} if balls is None else balls

    def ball(H):
        if H not in balls:
            balls[H] = float(np.mean([quad_run(prob, 0.04, H, 320 // H,
                                               seed=s, **kw)[-5:].mean()
                                      for s in range(3)]))
        return balls[H]

    coords = {"experiment": experiment}
    if experiment == "ball_vs_H":
        return [_row({**coords, "case": f"H{H}"},
                     {"gamma": 0.04, "H": H,
                      "sigma_dif2": float(prob.sigma_dif2()),
                      "value": ball(H)}) for H in (1, 4, 16)]
    if experiment != "bound":
        raise ValueError(f"thm2 experiment {experiment!r}; expected one of "
                         f"{THM2_EXPERIMENTS}")
    # a crude f-gap proxy 0.5·L·dist² against the analytic Thm-2 rhs
    spec = theory.ProblemSpec(mu=0.5, L=4.0, sigma2=0.04, alpha=1.0,
                              Gamma=1.0, M=8, H=4)
    rhs = float(theory.thm2_bound(spec, 0.04, 320 // 4,
                                  r0=float(np.sum(prob.x_star() ** 2)),
                                  sigma2_dif=prob.sigma_dif2()))
    lhs = 0.5 * 4.0 * ball(4)
    return [_row({**coords, "case": "check"},
                 {"bound_satisfied": int(lhs <= rhs), "lhs": float(lhs),
                  "rhs": rhs,
                  "bound_slack_x": round(rhs / max(lhs, 1e-12), 1)})]


def sec52_row(v_init, tau, *, device, rounds=SEC52["rounds"],
              use_fused_kernel=False, streams=None):
    """FedAdaGrad (η = 0.05, η_l = τ/2, no server momentum) on one client's
    quadratic, v₋₁ = 1 (``"one"``) or τ² (``"tau2"``): the mean server step
    norm over the rounds (the reference's ``_run_sec52``; its keys come
    from seed 1, as ``default_streams(0)``)."""
    device = torch.device(device)
    prob = QuadraticProblem.make(d=24, M=4, mu=0.5, L=4.0, sigma=0.3, seed=0)
    Q, b = _quad_tensors(prob, device)

    def loss(params, micro):
        x = params["x"]
        return 0.5 * (x - b[0]) @ Q[0] @ (x - b[0]) + micro["z"] @ x

    spec = engine.method_spec("fedadagrad", eta=0.05, eta_l=0.5 * tau,
                              tau=tau, server_beta1=0.0,
                              v_init=1.0 if v_init == "one" else None,
                              use_fused_kernel=use_fused_kernel)
    step = engine.build_round_step(loss, spec)
    gen = torch.Generator(device=device).manual_seed(0)
    state = engine.init_state(gen, lambda g: {"x": torch.zeros(
        24, device=device)}, spec, SEC52["clients"])
    loader = QuadraticLoader(prob, seed=0)
    streams = streams or default_streams(0)
    sn = []
    for r in range(rounds):
        state, met = step(state, to_device(
            loader.round_batch(SEC52["h_local"]), device), streams(r))
        sn.append(float(met["step_norm"]))
    return _row({"v_init": v_init, "tau": tau},
                {"mean_step_norm": float(np.mean(sn))})


# --------------------------------------------------------------------------- #
# summaries: the reference's _sum_* on a list of rows
# --------------------------------------------------------------------------- #


def _uniq(rows, axis):
    out = []
    for r in rows:
        v = r["coords"][axis]
        if v not in out:
            out.append(v)
    return out


def summary_fig1(rows):
    """Rounds to reach loss <= 1.2 (main_frac 0.3 and 0.5) and the loss at
    round 10 (main_frac 0.5), per method."""
    out = []
    for mname in _uniq(rows, "method"):
        for frac in (0.3, 0.5):
            seq = sorted((r["coords"]["round"], r["metrics"]["loss"])
                         for r in rows if r["coords"]["method"] == mname
                         and float(r["coords"]["main_frac"]) == frac)
            if not seq:
                continue
            hit = next((rd for rd, l in seq if l <= 1.2), -1)
            out.append((f"rounds_to_loss1.2_{int(frac * 100)}_"
                        f"{mname.replace(' ', '_')}", hit))
        l10 = [r["metrics"]["loss"] for r in rows
               if r["coords"]["method"] == mname
               and float(r["coords"]["main_frac"]) == 0.5
               and r["coords"]["round"] == 10]
        if l10:
            out.append((f"loss_at_r10_50_{mname.replace(' ', '_')}",
                        round(l10[0], 3)))
    return out


def summary_thm1(rows):
    m = {r["coords"]["case"]: r["metrics"] for r in rows}
    out = []
    if "gamma0.08" in m and "gamma0.02" in m:
        out.append(("ball_ratio_gamma_4x",
                    round(m["gamma0.08"]["value"] / m["gamma0.02"]["value"],
                          2)))
    if "M2" in m and "M8" in m:
        out.append(("ball_ratio_M_4x",
                    round(m["M2"]["value"] / m["M8"]["value"], 2)))
    if "rate" in m:
        out.append(("transient_rate_measured",
                    m["rate"]["transient_rate_measured"]))
        out.append(("transient_rate_bound_per_round",
                    m["rate"]["transient_rate_bound_per_round"]))
    return out


def summary_thm2(rows):
    m = {r["coords"]["case"]: r["metrics"] for r in rows}
    out = []
    if "H16" in m and "H1" in m:
        out.append(("ball_H16_over_H1",
                    round(m["H16"]["value"] / m["H1"]["value"], 2)))
    if "check" in m:
        out.append(("bound_satisfied", m["check"]["bound_satisfied"]))
        out.append(("bound_slack_x", m["check"]["bound_slack_x"]))
    return out


def summary_sec52(rows):
    m = {(r["coords"]["v_init"], float(r["coords"]["tau"])): r["metrics"]
         for r in rows}
    out = []
    for mode, label, nd in (("one", "stall_ratio_vinit1", 1),
                            ("tau2", "stall_ratio_vinit_tau2", 2)):
        hi, lo = m.get((mode, 0.1)), m.get((mode, 1e-5))
        if hi and lo:
            out.append((label, round(hi["mean_step_norm"]
                                     / max(lo["mean_step_norm"], 1e-12), nd)))
    return out


SUMMARIES = {"fig1": summary_fig1, "thm1": summary_thm1,
             "thm2": summary_thm2, "sec52": summary_sec52}


def summary(exp, rows):
    """The reference's summary metrics of ``exp`` over ``rows``: a list of
    (name, value)."""
    return SUMMARIES[exp](rows)


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", default="fig1", choices=[*EXPERIMENTS, "all"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--use-fused-kernel", action="store_true",
                    help="the flat-buffer client loop: one fused-step kernel "
                         "launch per local step")
    ap.add_argument("--rounds", type=int, default=None,
                    help="fig1's and sec52's rounds (default 25 and 5)")
    ap.add_argument("--seed", type=int, default=0,
                    help="fig1's data, split, init and round streams")
    ap.add_argument("--experiment", action="append",
                    choices=[*THM1_EXPERIMENTS, *THM2_EXPERIMENTS],
                    help="thm1 / thm2 experiments (repeatable; default all "
                         "of the chosen theorem's)")
    return ap


def run_exp(exp, args, device):
    """The rows of one experiment under the CLI's ``args``."""
    fused = args.use_fused_kernel
    if exp == "fig1":
        data = fig1_data(args.seed)
        rows = []
        for frac in MAIN_FRACS:
            parts = main_class_partition(data.y[:-FIG1["ntest"]],
                                         FIG1["clients"], frac,
                                         seed=args.seed)
            for method in FIG1_METHODS:
                rows += fig1_run(frac, method, device=device, seed=args.seed,
                                 data=data, parts=parts,
                                 rounds=args.rounds or FIG1["rounds"],
                                 use_fused_kernel=fused)
        return rows
    if exp == "sec52":
        return [sec52_row(v, tau, device=device, use_fused_kernel=fused,
                          rounds=args.rounds or SEC52["rounds"])
                for v, tau in SEC52_POINTS]
    known = THM1_EXPERIMENTS if exp == "thm1" else THM2_EXPERIMENTS
    chosen = [e for e in args.experiment or known if e in known]
    rows, balls = [], {}
    for e in chosen:
        if exp == "thm1":
            rows += thm1_rows(e, device=device, use_fused_kernel=fused)
        else:
            rows += thm2_rows(e, device=device, use_fused_kernel=fused,
                              balls=balls)
    return rows


def main(argv=None):
    """Run the chosen experiments; print and return ``{exp: {"rows": [...],
    "summary": {name: value}}}``."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for exp in EXPERIMENTS if args.exp == "all" else (args.exp,):
        t0 = time.perf_counter()
        rows = run_exp(exp, args, device)
        for r in rows:
            print(json.dumps({"exp": exp, **r}), flush=True)
        summ = dict(summary(exp, rows))
        print(json.dumps({"exp": exp, "summary": summ,
                          "device": str(device),
                          "seconds": time.perf_counter() - t0}), flush=True)
        out[exp] = {"rows": rows, "summary": summ}
    return out


if __name__ == "__main__":
    main()
