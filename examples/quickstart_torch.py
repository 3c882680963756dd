"""Quickstart on the PyTorch port: SAVIC (Local SGD + Adam scaling) on a
strongly-convex problem (the port's counterpart of ``examples/quickstart.py``).

Shows the public API end to end: preconditioner config, round-step builder,
state init, the training loop, and the theory predictors. Runs on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import PrecondConfig, SavicConfig, savic, theory
from repro_torch.data import QuadraticLoader, QuadraticProblem
from repro_torch.utils import rng
from repro_torch.utils.device import resolve_device

D, M, H, ROUNDS = 32, 8, 8, 40


def run(rounds=ROUNDS, device="cuda", streams=None):
    """SAVIC's rounds on the Section-5 quadratic; returns one row a round,
    ``(round, loss, |x - x*|^2, client drift)``. Round r draws from
    ``streams(r)`` (default ``TorchStream(2).fold(r)``); this spec draws
    nothing, so any stream gives the same rows."""
    device = resolve_device(device)
    # 1. a distributed problem: M=8 clients, heterogeneous quadratics
    problem = QuadraticProblem.make(d=D, M=M, mu=0.5, L=8.0, sigma=0.5,
                                    heterogeneity=2.0, seed=0)
    Q = torch.tensor(problem.Q, dtype=torch.float32, device=device)
    b = torch.tensor(problem.b, dtype=torch.float32, device=device)

    def loss_fn(params, micro):
        x = params["x"]
        Qm, bm = Q[micro["cid"]], b[micro["cid"]]
        return 0.5 * (x - bm) @ Qm @ (x - bm) + micro["z"] @ x

    # 2. SAVIC: Adam-style preconditioner, global scaling (Algorithm 1)
    pc = PrecondConfig(kind="adam", alpha=1e-2)
    sv = SavicConfig(gamma=0.005, beta1=0.9, scaling="global")
    round_step = savic.build_round_step(loss_fn, pc, sv)
    state = savic.init_state(
        torch.Generator(device=device),
        lambda g: {"x": torch.zeros(D, device=g.device)}, pc, sv, n_clients=M)

    # 3. train: H=8 local steps per communication round
    loader = QuadraticLoader(problem, seed=1)
    streams = streams or rng.TorchStream(2).fold
    xstar = torch.tensor(problem.x_star(), dtype=torch.float32, device=device)
    rows = []
    for r in range(rounds):
        batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in loader.round_batch(H=H).items()}
        batch["cid"] = batch["cid"].long()
        state, met = round_step(state, batch, streams(r))
        x = savic.average_params(state)["x"]
        rows.append((r, float(met["loss"]), float(torch.sum((x - xstar) ** 2)),
                     float(met["client_drift"])))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    rows = run(args.rounds, args.device)
    for r, loss, dist, drift in rows:
        if r % 10 == 0 or r == len(rows) - 1:
            print(f"round {r:3d}  loss {loss:8.4f}  |x-x*|^2 {dist:.4f}  "
                  f"client-drift {drift:.2e}")
    # 4. what the theory says
    spec = theory.ProblemSpec(mu=0.5, L=8.0, sigma2=0.25, alpha=1e-6,
                              Gamma=1.0, M=M, H=H)
    print(f"\nTheorem-1 contraction/step (Γ=1 scale): "
          f"{theory.thm1_rate(spec, 0.05):.5f}")
    print("Done — see examples/federated_heterogeneity_torch.py for the "
          "paper's Fig.1 experiment and examples/train_lm_torch.py for a "
          "~100M-param LM run.")
    return rows


if __name__ == "__main__":
    main()
