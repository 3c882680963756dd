"""The paper's experiment (Figure 1), miniaturized, on the PyTorch port (the
counterpart of ``examples/federated_heterogeneity.py``): compare {Local SGD,
Adam global/local, OASIS global/local} on heterogeneous federated
classification with the main-class partitioning protocol (30/50/70%).

  PYTHONPATH=src python examples/federated_heterogeneity_torch.py [--frac 0.5]
  PYTHONPATH=src python examples/federated_heterogeneity_torch.py \
      --het-model lognormal --async-buffer 4 --device cpu

``--het-model`` adds systems heterogeneity (per-client step times, the
budgeted local-step vector H_m) and ``--async-buffer B`` the staleness-
buffered server, as in the reference. A synthetic same-shape image dataset
and an MLP stand in for CIFAR-10/ResNet18; 10 clients, momentum 0.9,
scaling momentum 0.999. The MLP's weights come from an explicit
``torch.Generator``. Runs on the card unless ``--device cpu`` is given, and
writes the loss and test accuracy per round to ``--out`` (default
``examples/out/fig1_example_torch.csv``).
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.core import AsyncSpec, PrecondConfig, SavicConfig, savic
from repro_torch.data import (ClassificationData, FederatedLoader,
                              heterogeneity_score, main_class_partition)
from repro_torch.data.federated import (SYSTEMS_MODELS, local_steps_from_times,
                                        sample_step_times,
                                        simulated_round_time)
from repro_torch.models import mlp
from repro_torch.utils import rng
from repro_torch.utils.device import resolve_device

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out",
                   "fig1_example_torch.csv")

METHODS = {"SGD": ("identity", "global"),
           "Adam global": ("adam", "global"),
           "Adam local": ("adam", "local"),
           "OASIS global": ("oasis", "global"),
           "OASIS local": ("oasis", "local")}


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frac", type=float, default=0.5)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--h-local", type=int, default=6)
    ap.add_argument("--het-model", default="uniform",
                    choices=list(SYSTEMS_MODELS),
                    help="systems-heterogeneity model for per-client H_m")
    ap.add_argument("--het-sigma", type=float, default=0.6)
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="server staleness buffer depth B (0 = synchronous)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=OUT)
    return ap


def run(args, init_params=None, streams=None, say=print):
    """The five methods' rows ``(method, round, loss, test accuracy)``.
    ``init_params(generator)`` replaces the MLP's init (default
    ``models.mlp.init`` from ``torch.Generator().manual_seed(0)``) and
    ``streams(r)`` round r's rng stream (default ``TorchStream(1).fold``)."""
    device = resolve_device(args.device)
    data = ClassificationData.make(n=8000, n_classes=10, seed=0)
    xte = torch.from_numpy(data.x[-1000:]).to(device)
    yte = torch.from_numpy(data.y[-1000:].astype(np.int64)).to(device)
    parts = main_class_partition(data.y[:-1000], 10, args.frac, seed=0)
    say(f"main-class fraction {args.frac}: heterogeneity score "
        f"{heterogeneity_score(data.y[:-1000], parts):.3f}")

    local_steps = None
    asy = AsyncSpec(buffer_rounds=args.async_buffer)
    step_times = sample_step_times(args.het_model, 10, seed=0,
                                   sigma=args.het_sigma)
    if args.het_model != "uniform":
        local_steps = tuple(int(h) for h in
                            local_steps_from_times(step_times, args.h_local))
        t_sync = simulated_round_time(step_times, [args.h_local] * 10)
        t_here = simulated_round_time(step_times, local_steps,
                                      barrier="async",
                                      buffer_rounds=args.async_buffer) \
            if args.async_buffer else simulated_round_time(step_times,
                                                           local_steps)
        say(f"systems model {args.het_model}: H_m={list(local_steps)} "
            f"simulated round time {t_here:.2f} vs uniform-sync {t_sync:.2f}")

    streams = streams or rng.TorchStream(1).fold
    rows = []
    for name, (kind, scaling) in METHODS.items():
        pc = PrecondConfig(kind=kind, alpha=1e-2, beta2=0.999)
        sv = SavicConfig(gamma=0.002, beta1=0.9, scaling=scaling,
                         local_steps=local_steps, asynchrony=asy)
        step = savic.build_round_step(mlp.loss, pc, sv)
        gen = torch.Generator(device=device).manual_seed(0)
        state = savic.init_state(gen, init_params or mlp.init, pc, sv, 10)
        loader = FederatedLoader(data.x[:-1000],
                                 data.y[:-1000].astype(np.int32), parts,
                                 batch_size=64, seed=0)
        for r in range(args.rounds):
            nb = loader.round_batch(args.h_local)
            batch = {"x": torch.from_numpy(nb["x"]).to(device),
                     "y": torch.from_numpy(nb["y"].astype(np.int64)).to(
                         device)}
            state, met = step(state, batch, streams(r))
            rows.append((name, r, float(met["loss"]),
                         mlp.acc(savic.average_params(state), xte, yte)))
        say(f"{name:14s} final loss {rows[-1][2]:.4f} acc {rows[-1][3]:.3f}")
    return rows


def main(argv=None):
    args = _parser().parse_args(argv)
    rows = run(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("method,round,loss,test_acc\n")
        for r in rows:
            f.write(",".join(map(str, r)) + "\n")
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
