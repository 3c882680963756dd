"""Dry run of every (arch × input shape × mesh) on a fake world (counterpart
of ``repro/launch/dryrun.py``, which lowers and compiles on 512 fake XLA
host devices).

No card and no real process group: ``fake_world`` starts PyTorch's
``fake`` process group (``torch.testing._internal.distributed.fake_pg``)
of 256 ranks for the (16, 16) mesh or 512 for (2, 16, 16), in this one
process, as rank 0. ``steps.build_step`` builds the step on
``make_production_mesh``; the rank's part of its inputs is made under
``FakeTensorMode`` (shapes and dtypes, no storage) and the step runs
there under ``utils.cost.CostMode``, which counts FLOPs, bytes,
collectives, custom ops (K1 by name: ``repro_torch::fused_step_flat`` has
a fake kernel) and live bytes. The program traced is the eager program
the port runs, op for op; the fake group's collectives return at once.

Fake tensors are ``cuda`` tensors where this torch is built with CUDA. A
CPU-only build (this container's) cannot run autograd on a fake ``cuda``
tensor (the autograd engine asks for the CUDA device guard), so there the
fake tensors and the mesh are ``cpu``. Nothing the cost model counts
depends on it: the kernels' wrappers route a ``cpu`` tensor to the same
operator (K1), the model's kernel flags are off, and FLOPs and bytes come
from shapes and dtypes.

**Rank 0 stands for every rank.** The step is SPMD: every rank runs the
same ops on blocks of the same shapes, except where a leaf's split is
uneven, and then ``to_placements`` replicates the leaf on every rank (a
block is never more than one element larger than another's). Rank 0's
groups are those of its mesh coordinates (0, …, 0).

**Trip counts.** A train round is H local steps of one shape, then one
sync and server step. The dry run traces the round at H = 2 and H = 3 and
prices H steps as c(2) + (H − 2) · (c(3) − c(2)), which is exact for every
counter that is affine in H (the tests hold it against a whole H-step
trace; H = 1 is no base: ``DTensor`` gathers the (1, M) losses by a view
where a longer round needs a split and a cat); the peak is the H = 3
trace's plus the extra batch rows' bytes.
Under per-client ``local_steps`` (``--het-model``) and under the
controller the whole round is traced. ``local_steps_traced`` and
``trip_count`` record which.

**The controller's knobs are taken as given.** Its round reads H_m and k
to the host once (one copy of ``state["ctrl"]``), and a fake tensor has
no value to read. Its state leaves go in as fake tensors that carry
``controller.init_ctrl_state``'s values (``_Values``): an op whose tensor
arguments all carry values gets its output's value from the same op on
them, on the CPU, and a scalar read of such a tensor returns it. So the
round is traced at the initial knobs, as the reference lowers one
knob-agnostic program and records the initial knobs; the record's
``controller`` block keeps the spec, those knobs and the state leaves'
shapes.

**The record**, ``<out>/<arch>__<shape>__<mesh>[__<tag>].json``, keeps the
reference's keys where a key means the same: ``arch``, ``shape``,
``mesh``, ``n_devices``, ``tag``, ``kind``, ``mode``, ``method``,
``clients``, ``h_local``, ``flops``, ``bytes_accessed``,
``collective_bytes``, ``collective_by_kind``, ``collective_counts``,
``memory`` (``argument_size_in_bytes``, ``output_size_in_bytes``: exact,
from the rank's shapes), ``params``, ``active_params``, ``op_census``,
``ok``; and for train shapes ``compression``, ``sync_payload_per_client``,
``asynchrony``, ``flat_layout`` / ``flat_layout_sharded``,
``fused_kernel_fallback``, ``objective``, ``heterogeneity`` and
``controller`` where the reference has them. It adds ``seq_len``,
``global_batch``, ``peak_bytes`` (the rank's predicted peak),
``flops_by_dtype``, ``flops_by_matmul``, ``collective_intra_bytes`` /
``collective_inter_bytes``, ``custom_counts``, ``trace_s``,
``local_steps_traced``, ``trip_count`` and ``roofline``
(``launch/roofline.py``'s H100 terms). The reference's XLA-only keys have
no counterpart and are left out: ``flops_raw``, ``bytes_raw``,
``lower_s``, ``compile_s``, ``unknown_trip_loops``,
``collective_bytes_static``, ``collective_by_kind_static``,
``temp_size_in_bytes`` and ``generated_code_size_in_bytes``.

A pair that raises a ``NotImplementedError`` is recorded with ``ok: false``
and the message. Compression on a plan whose shard axes split the leaves
traces: its records count int8's MAX all-reduce of the per-client scales
and top-k's all-gather of candidates among the collectives.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 34 pairs
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod \\
      --shapes train_4k                                      # 10 pairs
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils._pytree import tree_map as pytree_map
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch import configs
from repro_torch.configs import get_config, get_shape, pairs_to_run
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.sharding import local_shard
from repro_torch.utils import cost, rng
from repro_torch.utils.tree import tree_leaves, tree_map

OUT_DIR = "results_torch/dryrun"


def fake_device() -> str:
    """``cuda`` where this torch is built with CUDA, else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks (this process is
    rank 0), destroyed on exit. Refuses to start beside a live group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _fake(shape_tree, dev):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=dev), shape_tree)


def _blocks(shape_tree, placements, mesh, dev):
    """This rank's blocks (copies) of fake full tensors."""
    return tree_map(lambda s, pl: local_shard(
        torch.empty(s.shape, dtype=s.dtype, device=dev), mesh,
        pl).clone(), shape_tree, placements)


class _Values(TorchDispatchMode):
    """Values carried by a few small fake tensors (module docstring, the
    controller's knobs). ``seeds`` maps fake tensors to real CPU tensors.
    An op whose tensor arguments all carry values runs on the values too
    (on the CPU) and its outputs carry the results; a scalar read of a
    tensor with a value returns it; an in-place op on a tensor with a value
    and an argument without one drops the value."""

    def __init__(self, seeds):
        super().__init__()
        self.values = WeakTensorKeyDictionary()
        for t, v in seeds.items():
            self.values[t] = v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        tensors = [t for t in flat if isinstance(t, torch.Tensor)]
        known = bool(tensors) and all(t in self.values for t in tensors)
        if known and func is torch.ops.aten._local_scalar_dense.default:
            with _disable_current_modes():
                return self.values[args[0]].item()
        out = func(*args, **kwargs)
        if not known:
            if func._schema.is_mutable:
                for t in tensors:
                    self.values.pop(t, None)
            return out
        real = lambda x: self.values[x] if isinstance(x, torch.Tensor) else x
        r_args = pytree_map(real, list(args))
        r_kwargs = {k: pytree_map(real, v) for k, v in kwargs.items()
                    if k != "device"}
        with _disable_current_modes():
            r_out = func(*r_args, **r_kwargs)
        for o, r in zip(tree_flatten(out)[0], tree_flatten(r_out)[0]):
            if isinstance(o, torch.Tensor):
                self.values[o] = r
        return out


def _trace(make_args, fn, grad, seeds=None):
    """Run ``fn(*make_args())`` on fake tensors under a ``CostMode``;
    ``seeds(args)`` gives the arguments' tensors that carry values
    (``_Values``). Returns (totals, peak bytes, argument bytes, output
    bytes)."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = make_args()
        mode = cost.CostMode(node_ranks=roofline.NODE_RANKS)
        mode.track(args)
        arg_bytes = _nbytes(args)
        values = _Values(seeds(args)) if seeds else contextlib.nullcontext()
        with torch.set_grad_enabled(grad), values, mode:
            out = fn(*args)
        out_bytes = _nbytes(out)
        del args, out
    return mode.totals(), mode.peak, arg_bytes, out_bytes


def _train_inputs(built, H, dev, int_dtype=None):
    """The rank's state (``engine.shard_state`` of a fake full state) and
    the whole round batch with H microbatches a client (its integer leaves
    in ``int_dtype`` if given)."""
    from repro_torch.core import engine
    state_shape, batch_shape = built.args
    plan = built.meta["shard_plan"]
    dtype = lambda v: int_dtype if int_dtype is not None \
        and not v.dtype.is_floating_point else v.dtype

    def make():
        state = engine.shard_state(_fake(state_shape, dev), plan)
        batch = {k: torch.empty((v.shape[0], H) + tuple(v.shape[2:]),
                                dtype=dtype(v), device=dev)
                 for k, v in batch_shape.items()}
        return state, batch
    return make


def _trace_train(built, dev, seed=0, int_dtype=None):
    """Trace the round (module docstring, trip counts). Returns (totals,
    peak, argument bytes, output bytes, local steps traced, trip count)."""
    H = built.meta["h_local"]
    stream = rng.TorchStream(seed + 1).fold(0)
    fn = lambda state, batch: built.fn(state, batch, stream)
    spec = built.meta["engine_spec"]
    inputs = lambda h: _train_inputs(built, h, dev, int_dtype)
    seeds = None
    if spec.controller.enabled:
        c0 = _init_ctrl(built)
        seeds = lambda args: {args[0]["ctrl"][k]: v for k, v in c0.items()}
    if spec.client.local_steps is not None or seeds or H <= 3:
        t, peak, a, o = _trace(inputs(H), fn, True, seeds)
        return t, peak, a, o, H, H
    t2, _, _, _ = _trace(inputs(2), fn, True)
    t3, peak3, a3, o = _trace(inputs(3), fn, True)
    with FakeTensorMode():
        a = _nbytes(inputs(H)())
    t = cost.combine((1, t2), (H - 2, t3), (2 - H, t2))
    return t, peak3 + a - a3, a, o, 5, H


def _init_ctrl(built):
    """``controller.init_ctrl_state`` for the built step's M clients (real
    CPU tensors)."""
    from repro_torch.core import controller
    M = built.args[0]["ctrl"]["h_m"].shape[0]
    return controller.init_ctrl_state(built.meta["engine_spec"].controller,
                                      M)


def _trace_serve(built, shape, m, dev):
    """Trace one prefill or decode step on this rank's blocks of mesh
    ``m``."""
    pl = built.in_placements
    if shape.kind == "prefill":
        params_shape, batch_shape = built.args

        def make():
            return (_blocks(params_shape, pl[0], m, dev),
                    _fake(batch_shape, dev))
        return _trace(make, built.fn, False)
    params_shape, cache_shape, token_shape, _ = built.args

    def make():
        return (_blocks(params_shape, pl[0], m, dev),
                _blocks(cache_shape, pl[1], m, dev),
                _fake(token_shape, dev), shape.seq_len - 1)
    return _trace(make, built.fn, False)


def _mesh(multi_pod, mesh_shape, dev):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type=dev)
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    return make_debug_mesh(tuple(mesh_shape), axes, device_type=dev)


def _train_extras(rec, built):
    """The reference's train-shape keys from the built step's meta."""
    from repro_torch.core import engine
    spec = built.meta["engine_spec"]
    params_one = tree_map(lambda s: torch.empty(s.shape[1:], dtype=s.dtype,
                                                device="meta"),
                          built.args[0]["params"])
    rec["compression"] = dataclasses.asdict(spec.sync.compression)
    rec["sync_payload_per_client"] = engine.bytes_on_wire(spec, params_one)
    rec["asynchrony"] = dataclasses.asdict(spec.sync.asynchrony)
    for k in ("flat_layout", "flat_layout_sharded", "fused_kernel_fallback",
              "objective"):
        if k in built.meta:
            rec[k] = built.meta[k]
    hs = spec.client.local_steps
    rec["heterogeneity"] = {
        "local_steps": list(hs) if hs is not None else None,
        **{k: built.meta[k] for k in
           ("het_model", "step_times", "sim_round_time_sync",
            "sim_round_time_budgeted", "sim_round_time_async")
           if k in built.meta}}
    if spec.controller.enabled:
        # the program reads its knobs from state["ctrl"] each round; the
        # record keeps the spec and the initial knobs it was traced at
        c0 = _init_ctrl(built)
        rec["controller"] = {
            "spec": dataclasses.asdict(spec.controller),
            "init_knobs": {"h_m": [int(h) for h in c0["h_m"].tolist()],
                           "k": float(c0["k"]), "b_eff": int(c0["b_eff"])},
            "state_leaves": {k: list(v.shape) for k, v in c0.items()}}


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mode: str = "auto", method: str = "savic", compression=None,
            het_model=None, het_seed: int = 0, het_sigma: float = 0.6,
            asynchrony=None, controller=None, use_fused_kernel: bool = False,
            objective=None, labeled_frac: float = 1.0, personal=None,
            out_dir: str = OUT_DIR, save: bool = True, call=None,
            tag: str = "", verbose: bool = True, reduced: bool = False,
            mesh_shape=None, h_local=None, shape=None,
            engine_spec=None, seed: int = 0, int_dtype=None):
    """Dry-run one pair on a fake world and return its record (module
    docstring). ``reduced``, ``mesh_shape`` (a debug mesh instead of the
    production one), ``h_local`` and ``shape`` (a ``ShapeConfig`` in place
    of the named one) cut a pair to test size; ``engine_spec`` and ``seed``
    go to
    ``steps.build_train_step``; ``int_dtype`` is the round batch's id
    dtype (the step's own, int32, by default)."""
    shape = shape or get_shape(shape_name)
    dev = fake_device()
    n = 512 if multi_pod else 256
    if mesh_shape is not None:
        n = 1
        for s in mesh_shape:
            n *= s
    cfg = get_config(arch, reduced=reduced)
    t0 = time.perf_counter()
    with fake_world(n):
        mesh = _mesh(multi_pod, mesh_shape, dev)
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "x".join(str(s) for s in mesh.mesh.shape),
               "n_devices": mesh.mesh.numel(), "tag": tag,
               "kind": shape.kind, "seq_len": shape.seq_len,
               "global_batch": shape.global_batch}
        try:
            if shape.kind == "train":
                built = steps.build_train_step(
                    arch, shape, mesh, mode=mode,
                    method=method, compression=compression,
                    het_model=het_model, het_seed=het_seed,
                    het_sigma=het_sigma, asynchrony=asynchrony,
                    controller=controller, objective=objective,
                    labeled_frac=labeled_frac, personal=personal,
                    use_fused_kernel=use_fused_kernel, call=call,
                    reduced=reduced, h_local=h_local,
                    engine_spec=engine_spec, seed=seed)
                t, peak, a, o, traced, trips = _trace_train(
                    built, dev, seed, int_dtype)
            else:
                build = steps.build_prefill_step \
                    if shape.kind == "prefill" else steps.build_serve_step
                built = build(arch, shape, mesh, call=call, reduced=reduced)
                t, peak, a, o = _trace_serve(built, shape, mesh, dev)
                traced = trips = None
        except NotImplementedError as e:
            rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                        "params": cfg.param_count(),
                        "active_params": cfg.active_param_count()})
            return _finish(rec, out_dir, save, verbose)
    rec.update({
        "mode": built.meta.get("mode", "serve"),
        "method": built.meta.get("method", ""),
        "clients": built.meta.get("clients", 0),
        "h_local": built.meta.get("h_local", 0),
        "trace_s": round(time.perf_counter() - t0, 2),
        **cost.summary(t),
        "memory": {"argument_size_in_bytes": a, "output_size_in_bytes": o},
        "peak_bytes": peak,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "ok": True,
    })
    if traced is not None:
        rec["local_steps_traced"], rec["trip_count"] = traced, trips
        _train_extras(rec, built)
    rec["roofline"] = roofline.terms(rec)
    return _finish(rec, out_dir, save, verbose)


def run_train_argv(argv, **kw):
    """One round of ``launch/train.py``'s mesh run with these arguments,
    dry: the mesh of ``--mesh`` / ``--mesh-shape``, the engine spec its
    flags give (``train._resolve_spec``), its model call (``--dtype``), its
    shapes (M clients of ``--batch`` × ``--seq``, ``--h-local``) and its
    int64 ids (``train.round_batch``). A
    round of the real run counts what this record counts (``chip_smoke.py``
    phase 15 holds them equal on the card). ``kw`` go to ``run_one``."""
    from repro_torch.launch import train
    from repro_torch.models import ModelCallConfig
    from repro_torch.sharding import plan_for
    args = train._parser().parse_args(argv)
    if args.mesh == "none":
        raise ValueError("run_train_argv dry-runs a --mesh run")
    multi = args.mesh == "production-2pod"
    shape = tuple(int(x) for x in args.mesh_shape.split("x")) \
        if args.mesh == "debug" else ((2, 16, 16) if multi else (16, 16))
    names = ("pod", "data", "model") if len(shape) == 3 \
        else ("data", "model")
    mode = args.mode if args.mode != "auto" else (
        "plain" if args.arch in steps.BIG_ARCHS else "paper")
    plan = plan_for(mode, "pod" in names)
    sizes = dict(zip(names, shape))
    M = 1
    for a in plan.client:
        M *= sizes[a]
    spec, _, _ = train._resolve_spec(args, M)
    name = f"train_cli_{args.seq}"
    sh = configs.ShapeConfig(name, args.seq, M * args.batch, "train")
    return run_one(args.arch, name, shape=sh, mode=args.mode,
                   reduced=args.reduced, mesh_shape=shape,
                   h_local=args.h_local, engine_spec=spec,
                   call=ModelCallConfig(dtype=getattr(torch, args.dtype)),
                   seed=args.seed, int_dtype=torch.int64, **kw)


def _finish(rec, out_dir, save, verbose):
    if verbose:
        if rec["ok"]:
            print(f"[dryrun] {rec['arch']:18s} {rec['shape']:12s} "
                  f"mesh={rec['mesh']:8s} mode={rec['mode']:10s} "
                  f"flops={rec['flops']:.3e} bytes="
                  f"{rec['bytes_accessed']:.3e} coll="
                  f"{rec['collective_bytes'] / 1e9:.2f}GB peak="
                  f"{rec['peak_bytes'] / 1e9:.2f}GB "
                  f"{rec['roofline']['dominant']} trace={rec['trace_s']}s",
                  flush=True)
        else:
            print(f"[dryrun] {rec['arch']:18s} {rec['shape']:12s} "
                  f"mesh={rec['mesh']:8s} not run: {rec['error']}",
                  flush=True)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        if rec["tag"]:
            name += f"__{rec['tag']}"
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="with --all: only these shapes (comma-separated)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="auto")
    ap.add_argument("--method", default="savic",
                    help="round-engine method for train shapes "
                         "(savic|fedavg|fedadagrad|fedadam|fedyogi|"
                         "local-adam)")
    ap.add_argument("--compression", default="none",
                    help="sync delta compression for train shapes "
                         "(none|topk|randk|int8-stochastic)")
    ap.add_argument("--compression-k", type=float, default=0.1)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--het-model", default="",
                    help="systems-heterogeneity model for train shapes "
                         "(uniform|lognormal|tiers)")
    ap.add_argument("--het-seed", type=int, default=0)
    ap.add_argument("--het-sigma", type=float, default=0.6)
    ap.add_argument("--async-buffer", type=int, default=0)
    ap.add_argument("--staleness-weight", default="constant")
    ap.add_argument("--controller", action="store_true")
    ap.add_argument("--use-fused-kernel", action="store_true",
                    help="flat-buffer fused client loop (K1 once a local "
                         "step; the record keeps the flat-view layout)")
    ap.add_argument("--objective", default="supervised")
    ap.add_argument("--labeled-frac", type=float, default=1.0)
    ap.add_argument("--personalize", default="")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--train-argv", default="",
                    help="dry-run one round of launch/train.py with these "
                         "arguments (a --mesh run) instead of a pair")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    from repro_torch.core.engine import AsyncSpec, CompressionSpec
    comp = None if args.compression == "none" else CompressionSpec(
        op=args.compression, k=args.compression_k,
        error_feedback=args.error_feedback)
    asy = None if not args.async_buffer else AsyncSpec(
        buffer_rounds=args.async_buffer, weighting=args.staleness_weight)
    het = args.het_model or None
    ctrl = None
    if args.controller:
        from repro_torch.core.controller import ControllerSpec
        ctrl = ControllerSpec(enabled=True, buffer_max=args.async_buffer)
        het = het or "lognormal"
    obj = None
    if args.objective != "supervised":
        from repro_torch.core.objectives import ObjectiveSpec
        obj = ObjectiveSpec(kind=args.objective)
    personal = tuple(p for p in args.personalize.split(",") if p) or None
    kw = dict(multi_pod=args.multi_pod, mode=args.mode, method=args.method,
              compression=comp, het_model=het, het_seed=args.het_seed,
              het_sigma=args.het_sigma, asynchrony=asy, controller=ctrl,
              objective=obj, labeled_frac=args.labeled_frac,
              personal=personal, use_fused_kernel=args.use_fused_kernel,
              out_dir=args.out, tag=args.tag)
    if args.train_argv:
        return run_train_argv(args.train_argv.split(), out_dir=args.out,
                              tag=args.tag)
    if not args.all:
        return run_one(args.arch, args.shape, **kw)
    shapes = [s for s in args.shapes.split(",") if s]
    t0 = time.perf_counter()
    failures, not_run = [], []
    for arch, shape in pairs_to_run():
        if shapes and shape not in shapes:
            continue
        try:
            rec = run_one(arch, shape, **kw)
            if not rec["ok"]:
                not_run.append((arch, shape, rec["error"]))
        except Exception as e:  # noqa: BLE001 (listed, then exit 1)
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] FAIL {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    print(f"[dryrun] done in {time.perf_counter() - t0:.1f} s; "
          f"{len(not_run)} not run, {len(failures)} failures", flush=True)
    for f in not_run:
        print("  NOT RUN:", *f)
    for f in failures:
        print("  FAIL:", *f)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
