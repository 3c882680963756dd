"""Training entry point for every engine method (counterpart of
``repro/launch/train.py``, single-device path ``--mesh none``).

Same flags and defaults as the reference, plus ``--device {cuda,cpu}``
(default cuda; without a card it raises). Flags for features the port has
not reached raise ``NotImplementedError``: meshes, checkpoints, compression,
heterogeneity, async buffers, the controller, objectives, personalization and
partial participation.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --method savic --use-fused-kernel --rounds 2 --h-local 2 --clients 4 \
      --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --device cpu --rounds 2 --clients 2 --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import PrecondConfig, SavicConfig, engine, savic
from repro_torch.data import LMRoundLoader, TokenStream
from repro_torch.data import federated
from repro_torch.models import ModelCallConfig, build
from repro_torch.utils.device import resolve_device


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--h-local", type=int, default=4)
    ap.add_argument("--clients", type=int, default=4, help="client count M")
    ap.add_argument("--batch", type=int, default=8, help="per-client batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default="none",
                    choices=["none", "debug", "production", "production-2pod"])
    ap.add_argument("--mesh-shape", default="2x2")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "paper", "paper_fsdp", "plain", "diloco"])
    ap.add_argument("--method", default="savic", choices=list(engine.METHODS))
    ap.add_argument("--preconditioner", default="adam",
                    choices=["identity", "adam", "rmsprop", "oasis",
                             "adahessian", "adagrad"])
    ap.add_argument("--scaling", default="global", choices=["global", "local"])
    ap.add_argument("--gamma", type=float, default=3e-3,
                    help="client step size (γ / η_l)")
    ap.add_argument("--beta1", type=float, default=0.9,
                    help="client heavy-ball momentum (savic/local-adam)")
    ap.add_argument("--alpha", type=float, default=1e-2)
    ap.add_argument("--server-eta", type=float, default=0.1)
    ap.add_argument("--server-beta1", type=float, default=0.9)
    ap.add_argument("--tau", type=float, default=1e-3)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--sync-dtype", default="")
    ap.add_argument("--compression", default="none",
                    choices=list(engine.COMPRESSION_OPS))
    ap.add_argument("--compression-k", type=float, default=0.1)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--het-model", default="uniform",
                    choices=list(federated.SYSTEMS_MODELS))
    ap.add_argument("--het-sigma", type=float, default=0.6)
    ap.add_argument("--het-seed", type=int, default=0)
    ap.add_argument("--async-buffer", type=int, default=0)
    ap.add_argument("--staleness-weight", default="constant",
                    choices=list(engine.STALENESS_WEIGHTINGS))
    ap.add_argument("--controller", action="store_true")
    ap.add_argument("--ctrl-h-min", type=int, default=1)
    ap.add_argument("--ctrl-noise-target", type=float, default=1.0)
    ap.add_argument("--ctrl-k-min", type=float, default=0.05)
    ap.add_argument("--ctrl-resid-guard", type=float, default=0.5)
    ap.add_argument("--objective", default="supervised",
                    choices=["supervised", "consistency", "pseudo-label"])
    ap.add_argument("--labeled-frac", type=float, default=1.0)
    ap.add_argument("--unlabeled-weight", type=float, default=1.0)
    ap.add_argument("--pseudo-threshold", type=float, default=0.9)
    ap.add_argument("--personalize", default="")
    ap.add_argument("--use-fused-kernel", action="store_true",
                    help="flat-buffer fused client loop: one launch of the "
                         "fused kernel per local step, every preconditioner "
                         "kind")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    return ap


def _unported_flags(args) -> list:
    """CLI features outside this slice of the port (the engine raises for the
    spec-level ones too; these are caught first, by flag name)."""
    out = []
    if args.mesh != "none":
        out.append("--mesh")
    if args.ckpt:
        out.append("--ckpt")
    if args.compression != "none" or args.error_feedback:
        out.append("--compression/--error-feedback")
    if args.het_model != "uniform":
        out.append("--het-model")
    if args.async_buffer:
        out.append("--async-buffer")
    if args.controller:
        out.append("--controller")
    if args.objective != "supervised" or args.labeled_frac < 1.0:
        out.append("--objective/--labeled-frac")
    if args.personalize:
        out.append("--personalize")
    if args.participation < 1.0:
        out.append("--participation")
    return out


def _resolve_spec(args):
    if args.method == "savic":
        pc = PrecondConfig(kind=args.preconditioner, alpha=args.alpha)
        sv = SavicConfig(gamma=args.gamma, beta1=args.beta1,
                         scaling=args.scaling,
                         participation=args.participation,
                         sync_dtype=args.sync_dtype,
                         use_fused_kernel=args.use_fused_kernel)
        return savic.engine_spec(pc, sv)
    return engine.method_spec(
        args.method, pc_kind=args.preconditioner, alpha=args.alpha,
        beta1=args.beta1, eta=args.server_eta, eta_l=args.gamma,
        tau=args.tau, server_beta1=args.server_beta1,
        participation=args.participation, sync_dtype=args.sync_dtype,
        use_fused_kernel=args.use_fused_kernel)


def setup(argv=None, init_params=None):
    """Parse ``argv`` and build what the rounds need: ``(args, device,
    round_step, state, loader, sim_t)``.

    ``init_params(generator) -> params`` replaces the model's own random
    init; tests pass the reference's weights through ``repro_torch.bridge``.
    """
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    missing = _unported_flags(args)
    if missing:
        raise NotImplementedError("not ported to repro_torch yet: "
                                  + ", ".join(missing))
    cfg = get_config(args.arch, reduced=args.reduced)
    call = ModelCallConfig(dtype=getattr(torch, args.dtype))
    M = args.clients
    spec = _resolve_spec(args)
    model = build(cfg, call)
    round_step = engine.build_round_step(model.loss, spec)
    step_times = federated.sample_step_times(
        args.het_model, M, seed=args.het_seed, sigma=args.het_sigma)
    sim_t = federated.simulated_round_time(step_times, [args.h_local] * M)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = engine.init_state(gen, init_params or model.init, spec, M)
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=args.seed), M,
                           args.batch)
    return args, device, round_step, state, loader, sim_t


def round_batch(loader, args, r, device):
    """Round ``r``'s (M, H, b, S) tokens/labels as int64 tensors on
    ``device``."""
    nb = loader.round_batch(r, args.h_local, args.seq)
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
            for k, v in nb.items()}


def main(argv=None, init_params=None):
    """Run the rounds; returns the per-round log records (loss, drift,
    [step_norm], sim_time, wall_s, tokens_per_s). See ``setup`` for
    ``init_params``."""
    args, device, round_step, state, loader, sim_t = setup(argv, init_params)
    tokens_round = args.clients * args.h_local * args.batch * args.seq
    log = []
    t0 = time.time()
    for r in range(args.rounds):
        batch = round_batch(loader, args, r, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tw = time.perf_counter()
        state, metrics = round_step(state, batch)
        loss = float(metrics["loss"])          # waits for the round
        wall = time.perf_counter() - tw
        drift = float(metrics["client_drift"])
        rec = {"round": r, "loss": loss, "drift": drift}
        extra = ""
        if "step_norm" in metrics:
            rec["step_norm"] = float(metrics["step_norm"])
            extra = f" step {rec['step_norm']:.3e}"
        rec["sim_time"] = round((r + 1) * sim_t, 4)  # simulated clock
        rec["wall_s"] = round(wall, 4)
        rec["tokens_per_s"] = round(tokens_round / wall, 1)
        log.append(rec)
        print(f"[train] round {r:4d} loss {loss:.4f} drift {drift:.3e}"
              f"{extra} ({time.time()-t0:.1f}s)", flush=True)
    if args.log:
        with open(args.log, "w") as f:
            json.dump(log, f)
    return log


if __name__ == "__main__":
    main()
