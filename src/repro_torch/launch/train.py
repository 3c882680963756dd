"""Training entry point for every engine method (counterpart of
``repro/launch/train.py``, single-device path ``--mesh none``).

Same flags and defaults as the reference, plus ``--device {cuda,cpu}``
(default cuda; without a card it raises). Flags for features the port has
not reached raise ``NotImplementedError``: meshes, checkpoints,
heterogeneity, async buffers, the controller, objectives and
personalization.

Round r draws from the stream ``TorchStream(seed + 1).fold(r)``
(``repro_torch.utils.rng``), as the reference keys round r with
``fold_in(PRNGKey(seed + 1), r)``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --method savic --use-fused-kernel --rounds 2 --h-local 2 --clients 4 \
      --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --method savic --compression int8-stochastic --error-feedback \
      --use-fused-kernel --rounds 2 --h-local 2 --clients 4 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --method savic --preconditioner oasis --participation 0.5 \
      --use-fused-kernel --rounds 2 --h-local 2 --clients 4 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --device cpu --rounds 2 --clients 2 --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import PrecondConfig, SavicConfig, engine, savic
from repro_torch.data import LMRoundLoader, TokenStream
from repro_torch.data import federated
from repro_torch.models import ModelCallConfig, build
from repro_torch.utils import rng
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
    return out


def _resolve_spec(args):
    comp = engine.CompressionSpec(op=args.compression, k=args.compression_k,
                                  error_feedback=args.error_feedback,
                                  use_fused_kernel=args.use_fused_kernel)
    if args.method == "savic":
        pc = PrecondConfig(kind=args.preconditioner, alpha=args.alpha)
        sv = SavicConfig(gamma=args.gamma, beta1=args.beta1,
                         scaling=args.scaling,
                         participation=args.participation,
                         sync_dtype=args.sync_dtype,
                         use_fused_kernel=args.use_fused_kernel,
                         compression=comp)
        return savic.engine_spec(pc, sv)
    return engine.method_spec(
        args.method, pc_kind=args.preconditioner, alpha=args.alpha,
        beta1=args.beta1, eta=args.server_eta, eta_l=args.gamma,
        tau=args.tau, server_beta1=args.server_beta1,
        participation=args.participation, sync_dtype=args.sync_dtype,
        compression=comp, use_fused_kernel=args.use_fused_kernel)


@dataclasses.dataclass
class Run:
    """What the rounds need, as ``setup`` builds it."""
    args: argparse.Namespace
    device: torch.device
    spec: engine.EngineSpec
    round_step: object             # (state, batch, stream) -> (state, metrics)
    state: dict
    loader: LMRoundLoader
    sim_t: float                   # simulated time of one round
    root: object                   # the run's rng stream; round r: fold(r)
    wire: dict                     # engine.bytes_on_wire for one client

    def stream(self, r: int):
        return self.root.fold(r)


def setup(argv=None, init_params=None, root_stream=None) -> Run:
    """Parse ``argv`` and build what the rounds need.

    ``init_params(generator) -> params`` replaces the model's own random
    init, and ``root_stream`` the run's rng stream
    (``TorchStream(seed + 1)``); tests pass the reference's weights through
    ``repro_torch.bridge`` and a stream that replays its draws.
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
    wire = engine.bytes_on_wire(spec, engine.average_params(state))
    print(f"[train] sync payload/client/round: {wire['total_bytes']/1e6:.3f} "
          f"MB ({wire['compression_x']}x vs uncompressed)", flush=True)
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=args.seed), M,
                           args.batch)
    root = root_stream if root_stream is not None \
        else rng.TorchStream(args.seed + 1)
    return Run(args, device, spec, round_step, state, loader, sim_t, root,
               wire)


def round_batch(loader, args, r, device):
    """Round ``r``'s (M, H, b, S) tokens/labels as int64 tensors on
    ``device``."""
    nb = loader.round_batch(r, args.h_local, args.seq)
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
            for k, v in nb.items()}


def main(argv=None, init_params=None, root_stream=None):
    """Run the rounds; returns the per-round log records (loss, drift,
    [step_norm], [compression_err, wire_bytes], delta_bytes, compression_x,
    sim_time, wall_s, tokens_per_s). See ``setup`` for ``init_params`` and
    ``root_stream``."""
    run = setup(argv, init_params, root_stream)
    args, device, state = run.args, run.device, run.state
    run.state = None                   # the loop below owns the state
    tokens_round = args.clients * args.h_local * args.batch * args.seq
    log = []
    t0 = time.time()
    for r in range(args.rounds):
        batch = round_batch(run.loader, args, r, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tw = time.perf_counter()
        state, metrics = run.round_step(state, batch, run.stream(r))
        loss = float(metrics["loss"])          # waits for the round
        wall = time.perf_counter() - tw
        drift = float(metrics["client_drift"])
        rec = {"round": r, "loss": loss, "drift": drift}
        extra = ""
        if "step_norm" in metrics:
            rec["step_norm"] = float(metrics["step_norm"])
            extra = f" step {rec['step_norm']:.3e}"
        if "compression_err" in metrics:
            rec["compression_err"] = float(metrics["compression_err"])
            rec["wire_bytes"] = [int(b) for b in metrics["wire_bytes"]]
            extra += f" comp_err {rec['compression_err']:.3e}"
        rec["delta_bytes"] = run.wire["delta_bytes"]
        rec["compression_x"] = run.wire["compression_x"]
        rec["sim_time"] = round((r + 1) * run.sim_t, 4)  # simulated clock
        rec["wall_s"] = round(wall, 4)
        rec["tokens_per_s"] = round(tokens_round / wall, 1)
        log.append(rec)
        del batch, metrics
        print(f"[train] round {r:4d} loss {loss:.4f} drift {drift:.3e}"
              f"{extra} ({time.time()-t0:.1f}s)", flush=True)
    if args.log:
        with open(args.log, "w") as f:
            json.dump(log, f)
    return log


if __name__ == "__main__":
    main()
