"""Training entry point for every engine method (counterpart of
``repro/launch/train.py``, single-device path ``--mesh none``).

Same flags and defaults as the reference, plus ``--device {cuda,cpu}``
(default cuda; without a card it raises): the methods, compression,
systems heterogeneity (``--het-model`` draws per-client step times and so
the per-client local steps H_m), the staleness buffer (``--async-buffer``),
the adaptive controller (``--controller``, which owns H_m and takes the
step times as its straggler trace), client objectives (``--objective``,
``--labeled-frac``) and personalization (``--personalize``). The flags for
features the port has not reached raise ``NotImplementedError``: meshes and
checkpoints.

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
      --method savic --use-fused-kernel --h-local 4 --het-model lognormal \
      --het-seed 1 --async-buffer 2 --staleness-weight polynomial --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --method local-adam --use-fused-kernel --objective consistency \
      --labeled-frac 0.5 --personalize final_norm --rounds 2
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
from repro_torch.core import (PrecondConfig, SavicConfig, engine, objectives,
                              savic)
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
                    choices=list(federated.SYSTEMS_MODELS),
                    help="systems-heterogeneity model for per-client local "
                         "steps H_m (applies to every method)")
    ap.add_argument("--het-sigma", type=float, default=0.6,
                    help="lognormal straggler sigma for --het-model lognormal")
    ap.add_argument("--het-seed", type=int, default=0)
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="server staleness buffer depth B (0 = synchronous)")
    ap.add_argument("--staleness-weight", default="constant",
                    choices=list(engine.STALENESS_WEIGHTINGS),
                    help="staleness weighting s(tau) for the delta FIFO")
    ap.add_argument("--controller", action="store_true",
                    help="adaptive communication-budget controller: "
                         "gradient-noise-driven H_m growth, EF-residual-"
                         "guarded compression k, straggler-spread buffer "
                         "depth; owns H_m (the --het-model trace is its "
                         "step_times)")
    ap.add_argument("--ctrl-h-min", type=int, default=1,
                    help="controller: initial global local-step budget H_t")
    ap.add_argument("--ctrl-noise-target", type=float, default=1.0,
                    help="controller: grow H_t while the gradient-noise EMA "
                         "exceeds this")
    ap.add_argument("--ctrl-k-min", type=float, default=0.05,
                    help="controller: floor of the compression-k schedule")
    ap.add_argument("--ctrl-resid-guard", type=float, default=0.5,
                    help="controller: EF-residual-norm ratio above which k "
                         "grows back toward 1")
    ap.add_argument("--objective", default="supervised",
                    choices=list(objectives.OBJECTIVES),
                    help="client objective: supervised, or the semi-"
                         "supervised consistency / pseudo-label losses")
    ap.add_argument("--labeled-frac", type=float, default=1.0,
                    help="fraction of each client's sequences carrying labels "
                         "(<1 attaches the per-sequence 'labeled' leaf)")
    ap.add_argument("--unlabeled-weight", type=float, default=1.0,
                    help="λ_u on the unlabeled objective term")
    ap.add_argument("--pseudo-threshold", type=float, default=0.9,
                    help="confidence gate for --objective pseudo-label")
    ap.add_argument("--personalize", default="",
                    help="comma-separated param-path substrings kept client-"
                         "resident (e.g. 'final_norm'); rejected under a "
                         "global non-identity D")
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
    """CLI features outside the port so far."""
    out = []
    if args.mesh != "none":
        out.append("--mesh")
    if args.ckpt:
        out.append("--ckpt")
    return out


def _resolve_spec(args, n_clients):
    """CLI knobs -> (EngineSpec, local_steps, step_times), as the
    reference's ``_resolve_spec``."""
    comp = engine.CompressionSpec(op=args.compression, k=args.compression_k,
                                  error_feedback=args.error_feedback,
                                  use_fused_kernel=args.use_fused_kernel)
    asy = engine.AsyncSpec(buffer_rounds=args.async_buffer,
                           weighting=args.staleness_weight)
    local_steps = ctrl = None
    step_times = federated.sample_step_times(
        args.het_model, n_clients, seed=args.het_seed, sigma=args.het_sigma)
    if args.controller:
        # the controller owns H_m; the sampled trace is its step times
        ctrl = engine.ControllerSpec(
            enabled=True, h_min=args.ctrl_h_min, h_max=args.h_local,
            noise_target=args.ctrl_noise_target, k_min=args.ctrl_k_min,
            resid_guard=args.ctrl_resid_guard, buffer_max=args.async_buffer,
            step_times=tuple(float(t) for t in step_times))
    elif args.het_model != "uniform":
        local_steps = tuple(int(h) for h in federated.local_steps_from_times(
            step_times, args.h_local))
    personal = tuple(p for p in args.personalize.split(",") if p)
    if args.method == "savic":
        pc = PrecondConfig(kind=args.preconditioner, alpha=args.alpha)
        sv = SavicConfig(gamma=args.gamma, beta1=args.beta1,
                         scaling=args.scaling,
                         participation=args.participation,
                         sync_dtype=args.sync_dtype,
                         use_fused_kernel=args.use_fused_kernel,
                         compression=comp, local_steps=local_steps,
                         asynchrony=asy)
        spec = savic.engine_spec(pc, sv)
    else:
        spec = engine.method_spec(
            args.method, pc_kind=args.preconditioner, alpha=args.alpha,
            beta1=args.beta1, eta=args.server_eta, eta_l=args.gamma,
            tau=args.tau, server_beta1=args.server_beta1,
            participation=args.participation, sync_dtype=args.sync_dtype,
            compression=comp, local_steps=local_steps, asynchrony=asy,
            use_fused_kernel=args.use_fused_kernel)
    if ctrl is not None:
        spec = dataclasses.replace(spec, controller=ctrl)
    if personal:
        spec = dataclasses.replace(spec, sync=dataclasses.replace(
            spec.sync, personal=personal))
    return spec, local_steps, step_times


@dataclasses.dataclass
class Run:
    """What the rounds need, as ``setup`` builds it."""
    args: argparse.Namespace
    device: torch.device
    spec: engine.EngineSpec
    round_step: object             # (state, batch, stream) -> (state, metrics)
    state: dict
    loader: LMRoundLoader
    step_times: object             # per-client relative step times (numpy)
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
    spec, local_steps, step_times = _resolve_spec(args, M)
    model = build(cfg, call)
    objective = objectives.build_objective(objectives.ObjectiveSpec(
        kind=args.objective, unlabeled_weight=args.unlabeled_weight,
        pseudo_threshold=args.pseudo_threshold), model=model)
    round_step = engine.build_round_step(model.loss, spec,
                                         objective=objective)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = engine.init_state(gen, init_params or model.init, spec, M)
    wire = engine.bytes_on_wire(spec, engine.average_params(state))
    print(f"[train] sync payload/client/round: {wire['total_bytes']/1e6:.3f} "
          f"MB ({wire['compression_x']}x vs uncompressed)", flush=True)
    sim_t = federated.simulated_round_time(
        step_times, local_steps or [args.h_local] * M,
        barrier="async" if args.async_buffer else "sync",
        buffer_rounds=args.async_buffer)
    if args.het_model != "uniform" or args.async_buffer:
        print(f"[train] het={args.het_model} H_m="
              f"{list(local_steps) if local_steps else 'uniform'} "
              f"buffer={args.async_buffer} simulated round time {sim_t:.3f} "
              f"(rel. units)", flush=True)
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=args.seed), M,
                           args.batch, labeled_frac=args.labeled_frac,
                           seed=args.seed)
    root = root_stream if root_stream is not None \
        else rng.TorchStream(args.seed + 1)
    return Run(args, device, spec, round_step, state, loader, step_times,
               sim_t, root, wire)


def round_batch(loader, args, r, device):
    """Round ``r``'s (M, H, b, S) tokens/labels as int64 tensors on
    ``device``, and the (M, H, b) fp32 ``labeled`` mask when the loader
    draws one."""
    nb = loader.round_batch(r, args.h_local, args.seq)
    return {k: torch.from_numpy(v).to(
        device=device, dtype=torch.float32 if k == "labeled" else torch.long)
        for k, v in nb.items()}


def main(argv=None, init_params=None, root_stream=None):
    """Run the rounds; returns the per-round log records (loss, drift,
    [step_norm], [compression_err, wire_bytes], [staleness], [ctrl_h_m,
    ctrl_h_t, ctrl_k, ctrl_b_eff, ctrl_gns_ema, delta_sq_mean, delta_sq_avg,
    payload_sq, sim_round_time | sim_time], delta_bytes, compression_x,
    wall_s, tokens_per_s). See ``setup`` for
    ``init_params`` and ``root_stream``."""
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
        if "staleness" in metrics:
            rec["staleness"] = float(metrics["staleness"])
        if "ctrl_h_m" in metrics:
            # the realized knobs; a per-round simulated time, so that a
            # resumed run logs the same rounds
            h_real = [int(h) for h in metrics["ctrl_h_m"].tolist()]
            b_real = int(metrics["ctrl_b_eff"])
            rec["ctrl_h_m"] = h_real
            rec["ctrl_h_t"] = int(metrics["ctrl_h_t"])
            rec["ctrl_k"] = round(float(metrics["ctrl_k"]), 6)
            rec["ctrl_b_eff"] = b_real
            rec["ctrl_gns_ema"] = round(float(metrics["ctrl_gns_ema"]), 6)
            # the round's observations, exactly: with compression_err they
            # let tests/_reference_controller.py replay the knobs
            for k in ("delta_sq_mean", "delta_sq_avg", "payload_sq"):
                rec[k] = float(metrics[k])
            extra += f" H_t {rec['ctrl_h_t']}"
            rec["sim_round_time"] = round(federated.simulated_round_time(
                run.step_times, h_real,
                barrier="async" if args.async_buffer else "sync",
                buffer_rounds=b_real or args.async_buffer), 4)
        else:
            rec["sim_time"] = round((r + 1) * run.sim_t, 4)  # simulated clock
        rec["delta_bytes"] = run.wire["delta_bytes"]
        rec["compression_x"] = run.wire["compression_x"]
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
