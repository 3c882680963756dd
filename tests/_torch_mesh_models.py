"""The model cases of the port's mesh tests (``tests/test_torch_mesh_models.py``),
run by ``tests/_torch_mesh_worker.py models`` on a (2, 2) CPU gloo mesh and,
for the comparisons, on one process.

* ``mesh_round``: reduced qwen2-0.5b, mamba2-1.3b and qwen2-moe-a2.7b, savic
  under ``paper`` (clients on data, model-axis shards), M 2, H 2, b 2, S 32,
  2 rounds, through ``launch.steps.build_train_step``, from the reference's
  init (adam with alpha 1e-2, gamma 1e-3).
* ``mesh_serve``: reduced qwen2-0.5b's bf16 weights served on the mesh,
  ``build_prefill_step`` (batch 4, a 16-token prompt, a 24-slot cache) then
  6 greedy ``build_serve_step`` steps (argmax over the real vocabulary).
* ``mesh_train_main``: ``launch.train.main --mesh debug --mesh-shape 2x2``
  on the fused loop.
* ``mesh_objective``: ``launch.train.main --mesh debug --mesh-shape 2x2
  --mode plain`` (M 1, the microbatch of 2 split over the data axis) with
  the LM objectives at ``--labeled-frac 0.5`` (consistency; pseudo-label
  at a gate the random init opens), so the ranks' labeled counts differ.
* ``mesh_ckpt``: ``launch.train.main --mesh debug --mesh-shape 2x2 --ckpt``
  (paper with int8 + EF on the tree loop; plain on the fused loop), 2
  rounds saved every round, then round 2's step deleted and round 1
  resumed from round 1's: each rank holds the resumed records and state
  bitwise; rank 0 holds the written step against the port's own save of
  the gathered state, and the resumed run's step against the first one,
  byte for byte.
"""
import os
import shutil

import numpy as np
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import PrecondConfig, SavicConfig, engine, savic
from repro_torch.data import LMRoundLoader, TokenStream
from repro_torch.launch import steps
from repro_torch.models import ModelCallConfig, build
from repro_torch.sharding import gather, local_shard
from repro_torch.utils import rng
from repro_torch.utils.tree import tree_map, tree_paths

ARCHS = ("qwen2-0.5b", "mamba2-1.3b", "qwen2-moe-a2.7b")
M, H, B, S, ROUNDS = 2, 2, 2, 32, 2
SERVE_B, PROMPT, CACHE, G = 4, 16, 24, 6
TRAIN_ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
              "--rounds", "2", "--h-local", "2", "--batch", "2", "--seq",
              "32", "--use-fused-kernel"]


def call():
    # remat off: it changes nothing numerically and halves compile time
    return ModelCallConfig(dtype=torch.float32, remat=False)


def spec(fused):
    return savic.engine_spec(PrecondConfig(kind="adam", alpha=1e-2),
                             SavicConfig(gamma=1e-3, beta1=0.9,
                                         use_fused_kernel=fused))


def batches(arch):
    cfg = get_config(arch, reduced=True)
    loader = LMRoundLoader(TokenStream(cfg.vocab_size, seed=0), M, B)
    return [loader.round_batch(r, H, S) for r in range(ROUNDS)]


def torch_batch(nb):
    return {k: torch.from_numpy(v).long() for k, v in nb.items()}


def to_numpy(tree):
    return tree_map(lambda t: t.detach().float().numpy().copy()
                    if isinstance(t, torch.Tensor) else t, tree)


def _rounds(step, state, arch):
    mets = []
    for r, nb in enumerate(batches(arch)):
        state, met = step(state, torch_batch(nb), rng.TorchStream(1).fold(r))
        mets.append(to_numpy(met))
    return state, mets


def _init(params, sp):
    return engine.init_state(torch.Generator(), lambda g: {
        k: tree_map(torch.clone, v) for k, v in params.items()}, sp, M)


def mesh_round(arch, params, mesh, fused):
    """(full final state, metrics, the built step's meta: its keys and
    the sharded flat layout's description on the fused loop)."""
    sp = spec(fused)
    built = steps.build_train_step(
        arch, ShapeConfig("mesh_test", S, M * B, "train"), mesh,
        mode="paper", engine_spec=sp, reduced=True, h_local=H, call=call())
    plan = built.meta["shard_plan"]
    state = engine.shard_state(_init(params, sp), plan)
    state, mets = _rounds(built.fn, state, arch)
    meta = {"keys": sorted(built.meta),
            "flat": built.meta.get("flat_layout_sharded")}
    return to_numpy(engine.gather_state(state, plan)), mets, meta


def single_round(arch, params, fused):
    sp = spec(fused)
    model = build(get_config(arch, reduced=True), call())
    state, mets = _rounds(engine.build_round_step(model.loss, sp),
                          _init(params, sp), arch)
    return to_numpy(state), mets


def prompt():
    cfg = get_config("qwen2-0.5b", reduced=True)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(SERVE_B, PROMPT)).astype(np.int64)
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}


def mesh_serve(params_bf16, mesh):
    """(per-step full logits (G + 1, B, V), greedy ids (G, B))."""
    cfg = get_config("qwen2-0.5b", reduced=True)
    pre = steps.build_prefill_step(
        "qwen2-0.5b", ShapeConfig("prefill_test", PROMPT, SERVE_B, "prefill"),
        mesh, call=ModelCallConfig(dtype=torch.float32), reduced=True,
        cache_len=CACHE)
    srv = steps.build_serve_step(
        "qwen2-0.5b", ShapeConfig("decode_test", CACHE, SERVE_B, "decode"),
        mesh, call=ModelCallConfig(dtype=torch.float32), reduced=True)
    mine = tree_map(lambda x, pl: local_shard(x, mesh, pl), params_bf16,
                    pre.in_placements[0])
    shape = (SERVE_B, cfg.vocab_size)
    lg, cache = pre.fn(mine, prompt())
    lg = gather(lg, mesh, pre.out_placements[0], shape)
    logits, ids = [lg], []
    for g in range(G):
        tok = logits[-1][:, :cfg.vocab_size].argmax(-1)
        ids.append(tok)
        lg, cache = srv.fn(mine, cache, tok, PROMPT + g)
        logits.append(gather(lg, mesh, srv.out_placements[0], shape))
    return (torch.stack(logits).float().numpy(),
            torch.stack(ids).numpy())


def single_serve(params_bf16):
    cfg = get_config("qwen2-0.5b", reduced=True)
    model = build(cfg, ModelCallConfig(dtype=torch.float32))
    with torch.inference_mode():
        lg, cache = model.prefill_cache(params_bf16, prompt(), CACHE)
        logits, ids = [lg], []
        for g in range(G):
            tok = logits[-1][:, :cfg.vocab_size].argmax(-1)
            ids.append(tok)
            lg, cache = model.decode(params_bf16, cache, tok, PROMPT + g)
            logits.append(lg)
    return (torch.stack(logits).float().numpy(),
            torch.stack(ids).numpy())


OBJECTIVE_CASES = {
    "consistency": ["--objective", "consistency"],
    "pseudo-label": ["--objective", "pseudo-label", "--pseudo-threshold",
                     "1e-4"],
}
OBJECTIVE_ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                  "--rounds", "2", "--h-local", "2", "--batch", "2", "--seq",
                  "32", "--labeled-frac", "0.5", "--mode", "plain"]


def mesh_objective():
    from repro_torch.launch import train
    return {name: train.main(OBJECTIVE_ARGV + extra + [
        "--mesh", "debug", "--mesh-shape", "2x2"], return_state=True)
        for name, extra in OBJECTIVE_CASES.items()}


CKPT_CASES = {
    "paper-int8-ef": ["--mode", "paper", "--compression", "int8-stochastic",
                      "--error-feedback"],
    "plain-fused": ["--mode", "plain", "--use-fused-kernel"],
}
CKPT_ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
             "--rounds", "2", "--h-local", "2", "--batch", "2", "--seq",
             "32", "--mesh", "debug", "--mesh-shape", "2x2", "--ckpt-every",
             "1"]
MEASURED = ("wall_s", "tokens_per_s")


def step_files(path):
    out = []
    for name in ("state.msgpack", "data.bin"):
        with open(os.path.join(path, name), "rb") as f:
            out.append(f.read())
    return out


def mesh_ckpt(outdir, rank):
    """The ``--ckpt`` runs of every case in every rank (module docstring);
    returns rank 0's findings, the gathered state in its own dtypes and
    each checkpoint's directory."""
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train
    det = lambda rec: {k: v for k, v in rec.items() if k not in MEASURED}
    out = {}
    for name, extra in CKPT_CASES.items():
        d = os.path.join(outdir, "ckpt_" + name)
        argv = CKPT_ARGV + extra + ["--ckpt", d]
        log_a, st_a = train.main(argv, return_state=True)
        step2 = os.path.join(d, "step_00000002")
        first = os.path.join(outdir, "first_" + name)
        found = {}
        if rank == 0:
            ref = ckpt.save(os.path.join(outdir, "gathered_" + name), 2,
                            st_a)
            found["written_is_gathered"] = step_files(step2) == \
                step_files(ref)
            shutil.move(step2, first)
        dist.barrier()
        log_b, st_b = train.main(argv, return_state=True)
        assert [r["round"] for r in log_b] == [1], log_b
        assert det(log_b[0]) == det(log_a[1])
        for (p, a), (q, b) in zip(tree_paths(st_b), tree_paths(st_a)):
            assert p == q and torch.equal(a, b), p
        if rank == 0:
            found["resumed_step_is_first"] = step_files(step2) == \
                step_files(first)
        out[name] = dict(found, dir=d, log=log_a, state=tree_map(
            lambda t: t.detach().numpy().copy(), st_a))
    return out


def mesh_train_main():
    from repro_torch.launch import train
    log, state = train.main(TRAIN_ARGV + ["--mesh", "debug", "--mesh-shape",
                                          "2x2", "--mode", "paper"],
                            return_state=True)
    return log, to_numpy(state)
