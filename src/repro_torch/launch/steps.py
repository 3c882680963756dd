"""Step builders: (arch × input shape × mesh × mode) -> a step function, its
abstract inputs and their ``DTensor`` placements (counterpart of
``repro/launch/steps.py``).

Shape kinds:
* train   -> the engine's ``round_step`` (H local steps × M clients + sync)
* prefill -> ``prefill`` / ``prefill_cache`` (last logits + KV cache)
* decode  -> ``serve_step`` (ONE new token against a seq_len KV cache)

``args`` are shape trees of ``meta`` tensors (nothing allocated, at every
size). The reference's shardings are the placement trees of
``sharding.to_placements``: one placement per mesh dim for every leaf.

A step runs in every rank of the mesh. The train step takes this rank's part
of the engine state (``engine.shard_state`` of the full state) and the whole
round batch, of which the engine reads its client's rows and its rows of
each microbatch; the metrics are the round's on every rank. The serve steps
take this rank's blocks of the bf16 params (and of the cache) and the whole
batch: each rank gathers the params (``Replicate``), runs its rows of the
batch with the cache gathered to its rows, and keeps its blocks of the
cache. Under ``use_fused_kernel`` a state whose client leaves are not fp32
takes the tree loop, as the reference's does: ``engine.fused_route`` turns
the flag off at build time and ``meta["fused_kernel_fallback"]`` names the
leaf group (a routing by dtype, not a fallback on a kernel failure).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import (ShapeConfig, get_config, get_shape,
                                 param_shapes)
from repro_torch.core import (PrecondConfig, SavicConfig, engine, objectives,
                              savic)
from repro_torch.models import ModelCallConfig, batch_struct, build
from repro_torch.sharding import (AxisPlan, PartitionSpec, batch_pspecs,
                                  cache_pspecs, local_shard, params_pspecs,
                                  plan_for, serve_batch_pspecs, to_placements)
from repro_torch.sharding.partitioner import _axsize as _ax
from repro_torch.utils import rng
from repro_torch.utils.flatten import FlatLayout, ShardedFlatPlan
from repro_torch.utils.tree import tree_map

P = PartitionSpec

# archs whose full replica does not fit a model group in fp32 training
# (plain mode: M = 1, params FSDP-sharded over the data axis)
BIG_ARCHS = ("deepseek-67b", "deepseek-v2-236b")

# decode window (ring-buffer KV) of the long_500k shape on windowed archs
LONG_DECODE_WINDOW = 8192


@dataclasses.dataclass
class BuiltStep:
    fn: Any                   # the step, run in every rank of the mesh
    args: tuple               # shape trees (meta tensors) of the inputs
    in_placements: tuple      # DTensor placements per input leaf
    out_placements: Any
    donate: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)


def _meta(tree):
    """A tree of fake or real tensors as ``meta`` tensors."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _struct(cfg, batch: int, seq: int, lead=()):
    """``batch_struct`` as ``meta`` tensors behind the ``lead`` dims."""
    return {k: torch.empty(tuple(lead) + tuple(shape), dtype=dt,
                           device="meta")
            for k, (shape, dt) in batch_struct(cfg, batch, seq).items()}


def _placements(mesh, spec_tree, shape_tree):
    return tree_map(lambda s, x: to_placements(mesh, s, tuple(x.shape)),
                    spec_tree, shape_tree)


def _train_plan(arch: str, mesh, mode: str = "auto"):
    multi = "pod" in mesh.mesh_dim_names
    if mode == "auto":
        mode = "plain" if arch in BIG_ARCHS else "paper"
    return plan_for(mode, multi), mode


def savic_round_h(shape: ShapeConfig) -> int:
    return 8  # the reference's local steps per round in its dry-run


def _method_engine_spec(method: str, pc_kind: str,
                        sv: Optional[SavicConfig]) -> engine.EngineSpec:
    """The engine spec of a train-step method selector."""
    if method == "savic":
        pc = PrecondConfig(kind=pc_kind, alpha=1e-2)
        return savic.engine_spec(pc, sv or SavicConfig(gamma=3e-4, beta1=0.9))
    if sv is not None:
        raise ValueError(f"sv= (SavicConfig) only applies to method='savic', "
                         f"got method={method!r}")
    return engine.method_spec(method, pc_kind=pc_kind)


def build_train_step(arch: str, shape: ShapeConfig, mesh, *,
                     mode: str = "auto", method: str = "savic",
                     pc_kind: str = "adam",
                     call: Optional[ModelCallConfig] = None,
                     reduced: bool = False, h_local: Optional[int] = None,
                     sv: Optional[SavicConfig] = None,
                     engine_spec: Optional[engine.EngineSpec] = None,
                     compression: Optional[engine.CompressionSpec] = None,
                     het_model: Optional[str] = None, het_seed: int = 0,
                     het_sigma: float = 0.6,
                     local_steps: Optional[tuple] = None,
                     asynchrony: Optional[engine.AsyncSpec] = None,
                     controller: Optional[engine.ControllerSpec] = None,
                     objective: Optional[objectives.ObjectiveSpec] = None,
                     labeled_frac: float = 1.0,
                     personal: Optional[tuple] = None,
                     use_fused_kernel: bool = False, seed: int = 0):
    """The SAVIC round on ``mesh``: ``fn(state, batch, stream=None) ->
    (state, metrics)`` with ``state`` this rank's part, ``batch`` the whole
    (M, H, b, ...) round and ``stream`` the round's rng stream (default
    ``TorchStream(seed).fold(state["round"])``, as the reference folds its
    key with the carried round counter)."""
    cfg = get_config(arch, reduced=reduced)
    plan, mode = _train_plan(arch, mesh, mode)
    call = call or ModelCallConfig()
    if mode in ("paper_fsdp", "plain") and call.act_shard is None:
        call = dataclasses.replace(
            call, act_shard=_act_shard_fn(mesh, plan))
    if cfg.moe and call.moe_shard is None:
        call = dataclasses.replace(call,
                                   moe_shard=_moe_shard_fn(cfg, mesh, plan))
    model = build(cfg, call)
    M = plan.clients(mesh) if plan.client else 1
    assert shape.global_batch % M == 0, (shape.global_batch, M)
    b_client = shape.global_batch // M
    H = h_local or savic_round_h(shape)

    spec = engine_spec or _method_engine_spec(method, pc_kind, sv)
    if compression is not None:
        spec = dataclasses.replace(
            spec, sync=dataclasses.replace(spec.sync, compression=compression))
    het_meta = {}
    if het_model is not None and local_steps is None:
        from repro_torch.data import federated as fed
        step_times = fed.sample_step_times(het_model, M, seed=het_seed,
                                           sigma=het_sigma)
        local_steps = tuple(int(h) for h in
                            fed.local_steps_from_times(step_times, H))
        asy = asynchrony or spec.sync.asynchrony
        het_meta = {
            "het_model": het_model,
            "step_times": [round(float(t), 4) for t in step_times],
            "sim_round_time_sync": round(fed.simulated_round_time(
                step_times, [H] * M, barrier="sync"), 4),
            "sim_round_time_budgeted": round(fed.simulated_round_time(
                step_times, local_steps, barrier="sync"), 4),
        }
        if asy.buffer_rounds > 0:
            het_meta["sim_round_time_async"] = round(fed.simulated_round_time(
                step_times, local_steps, barrier="async",
                buffer_rounds=asy.buffer_rounds), 4)
        if controller is not None and controller.enabled \
                and not controller.step_times:
            controller = dataclasses.replace(
                controller, step_times=tuple(float(t) for t in step_times))
    if controller is not None and controller.enabled:
        local_steps = None
        spec = dataclasses.replace(spec, controller=controller)
        het_meta["controller"] = dataclasses.asdict(controller)
    if local_steps is not None:
        spec = dataclasses.replace(
            spec, client=dataclasses.replace(spec.client,
                                             local_steps=tuple(local_steps)))
    if asynchrony is not None:
        spec = dataclasses.replace(
            spec, sync=dataclasses.replace(spec.sync, asynchrony=asynchrony))
    if use_fused_kernel:
        spec = dataclasses.replace(
            spec, client=dataclasses.replace(spec.client,
                                             use_fused_kernel=True))
    if personal:
        spec = dataclasses.replace(
            spec, sync=dataclasses.replace(spec.sync,
                                           personal=tuple(personal)))
    client_objective = objectives.build_objective(objective, model=model)
    if client_objective is not None or labeled_frac < 1.0 or personal:
        het_meta["objective"] = {
            "kind": objective.kind if objective is not None else "supervised",
            "labeled_frac": labeled_frac,
            "personal": list(spec.sync.personal),
        }

    # ---- abstract state and batch ------------------------------------------
    with FakeTensorMode():
        state_shape = _meta(engine.init_state(torch.Generator(), model.init,
                                              spec, M))
    micro = _struct(cfg, b_client, shape.seq_len, lead=(M, H))
    if labeled_frac < 1.0:
        micro["labeled"] = torch.empty((M, H, b_client), device="meta")
    batch_shape = micro

    spec, why = engine.fused_route(spec, state_shape)
    if why:
        het_meta["fused_kernel_fallback"] = why
    shard_axes = tuple(plan.model) + (tuple(plan.batch)
                                      if plan.fsdp_params else ())
    params_one = tree_map(lambda s: torch.empty(s.shape[1:], dtype=s.dtype,
                                                device="meta"),
                          state_shape["params"])
    pspecs_one = params_pspecs(cfg, params_one, mesh, plan, client_dim=False)
    shard_plan = ShardedFlatPlan.build(
        mesh, params_one, pspecs_one, shard_axes,
        client=tuple(plan.client) if plan.client else None,
        batch=tuple(plan.batch))
    if spec.client.use_fused_kernel:
        if _ax(mesh, plan.model) > 1 or plan.fsdp_params:
            het_meta["flat_layout_sharded"] = shard_plan.layout.describe()
        else:
            het_meta["flat_layout"] = FlatLayout.for_tree(
                state_shape["params"], batch_dims=1).describe()
    round_step = engine.build_round_step(model.loss, spec,
                                         objective=client_objective,
                                         shard_plan=shard_plan)

    def step(state, batch, stream=None):
        if stream is None:
            stream = rng.TorchStream(seed).fold(int(state["round"]))
        return round_step(state, batch, stream)

    state_spec = _engine_state_spec(cfg, state_shape, mesh, plan, spec)
    batch_spec = batch_pspecs(batch_shape, mesh, plan, client_dim=True)
    state_pl = _placements(mesh, state_spec, state_shape)
    return BuiltStep(
        fn=step,
        args=(state_shape, batch_shape),
        in_placements=(state_pl, _placements(mesh, batch_spec, batch_shape)),
        # the metrics are the round's on every rank
        out_placements=(state_pl, None),
        donate=(0,),
        meta={"mode": mode, "method": method, "clients": M, "h_local": H,
              "b_client": b_client, "cfg": cfg, "plan": plan,
              "engine_spec": spec, "shard_plan": shard_plan,
              "state_spec": state_spec, **het_meta},
    )


def _engine_state_spec(cfg, state_shape, mesh, plan, spec: engine.EngineSpec):
    """PartitionSpec tree of an engine state: client leaves carry a leading
    M dim over the client axes; the global D and the adaptive server's m/v
    are single-replica trees; the FIFO has a leading, never sharded B dim;
    server, EF and FIFO trees hold ``None`` at personal leaves; the
    controller's state is replicated (every rank holds all of it, ``h_m``
    for all M clients)."""
    pspec_m = params_pspecs(cfg, state_shape["params"], mesh, plan,
                            client_dim=True)
    state_spec = {
        "params": pspec_m,
        "mom": pspec_m,
        "precond": _precond_spec(cfg, state_shape["precond"], mesh, plan,
                                 local=spec.client.scaling == "local"),
        "round": P(),
    }
    if "server" in state_shape:
        pspec_1 = params_pspecs(cfg, state_shape["server"]["m"], mesh, plan,
                                client_dim=False)
        state_spec["server"] = {"m": pspec_1, "v": pspec_1}
    if "ef" in state_shape:
        state_spec["ef"] = engine.strip_personal(spec.sync.personal, pspec_m)
    if "buffer" in state_shape:
        buf_one = tree_map(lambda s: torch.empty(s.shape[1:], dtype=s.dtype,
                                                 device="meta"),
                           state_shape["buffer"])
        pspec_buf = params_pspecs(cfg, buf_one, mesh, plan, client_dim=False)
        state_spec["buffer"] = tree_map(lambda s: P(None, *s), pspec_buf)
    if "ctrl" in state_shape:
        state_spec["ctrl"] = {k: P() for k in state_shape["ctrl"]}
    return state_spec


def _act_shard_fn(mesh, plan):
    """The residual input's layout on batch-parallel plans: batch rows over
    the batch axes. Applied to a ``DTensor`` activation it redistributes
    it there; the port's mesh forward runs on plain tensors (each rank its
    rows, on the gathered params), which it returns unchanged."""
    spec = P(tuple(plan.batch), None, None)
    return lambda x: _redistribute(x, mesh, spec)


def _moe_shard_fn(cfg, mesh, plan):
    """The (B, E, C, d/f) MoE buffers' layout: batch over the batch axes,
    experts over the model axes when divisible (the dispatch buffer only).
    Like ``_act_shard_fn``, it redistributes a ``DTensor`` and returns a
    plain tensor unchanged."""
    baxes = tuple(plan.batch) or None
    E = cfg.moe.n_experts
    eaxes = tuple(plan.model) if (plan.model
                                  and E % _ax(mesh, plan.model) == 0) else None

    def f(x, where="dispatch"):
        e = eaxes if where == "dispatch" else None
        return _redistribute(x, mesh, P(baxes, e, *([None] * (x.dim() - 2))))
    return f


def _redistribute(x, mesh, spec):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, to_placements(mesh, spec, tuple(x.shape)))


def _precond_spec(cfg, precond_shape, mesh, plan, local):
    # local scaling keeps a per-client step counter t of shape (M,)
    t_spec = P(plan.client if plan.client else None) \
        if precond_shape["t"].dim() else P()
    spec = {"t": t_spec}
    if "d" in precond_shape:
        spec["d"] = params_pspecs(cfg, precond_shape["d"], mesh, plan,
                                  client_dim=local)
    return spec


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #


def _serve_plan(arch: str, mesh) -> AxisPlan:
    multi = "pod" in mesh.mesh_dim_names
    batch = ("pod", "data") if multi else ("data",)
    return AxisPlan(client=(), batch=batch, model=("model",),
                    fsdp_params=arch in BIG_ARCHS)


def _serve_call(arch: str, shape: ShapeConfig,
                call: Optional[ModelCallConfig]):
    if call is not None:
        return call
    window = LONG_DECODE_WINDOW if shape.name == "long_500k" else 0
    return ModelCallConfig(decode_window=window)


def _bf16_params(params_shape):
    """Serving stores weights in bf16 (training keeps fp32 masters)."""
    return tree_map(lambda s: torch.empty(
        s.shape, dtype=torch.bfloat16 if s.dtype == torch.float32
        else s.dtype, device="meta"), params_shape)


def _rows(spec, dim: int):
    """``spec`` with every entry but the batch dim's dropped."""
    return P(*[e if i == dim else None for i, e in enumerate(spec)])


def _relayout(mesh, tree, shapes, src, dst):
    """Leaf by leaf from the ``src`` specs' blocks to the ``dst`` specs'
    (DTensor ``redistribute``: a gather where ``dst`` shards less, a slice
    where it shards more)."""
    from torch.distributed.tensor import DTensor

    def one(x, shp, s, d):
        shp = tuple(shp.shape)
        sp, dp = to_placements(mesh, s, shp), to_placements(mesh, d, shp)
        if sp == dp:
            return x
        stride = torch.empty(shp, device="meta").stride()
        dt = DTensor.from_local(x.contiguous(), mesh, sp, run_check=False,
                                shape=torch.Size(shp), stride=stride)
        return dt.redistribute(mesh, dp).to_local()
    return tree_map(one, tree, shapes, src, dst)


def _full_params(mesh, params, shapes, pspec):
    return _relayout(mesh, params, shapes, pspec,
                     tree_map(lambda s: P(), pspec))


def _my_rows(mesh, tree, shapes, specs):
    return tree_map(lambda x, shp, s: local_shard(
        x, mesh, to_placements(mesh, s, tuple(shp.shape))), tree, shapes,
        specs)


def build_prefill_step(arch: str, shape: ShapeConfig, mesh, *,
                       call: Optional[ModelCallConfig] = None,
                       reduced: bool = False,
                       cache_len: Optional[int] = None):
    """Full-sequence prefill on the serve mesh: ``fn(params, batch) ->
    (logits, cache)``, this rank's blocks of each (``params`` its bf16
    blocks, ``batch`` the whole batch). With ``cache_len`` the step is
    ``model.prefill_cache``: the cache is in decode layout, so a serve step
    continues at pos = seq_len with no prompt replay."""
    cfg = get_config(arch, reduced=reduced)
    call = call or ModelCallConfig()
    plan = _serve_plan(arch, mesh)
    if cfg.moe and call.moe_shard is None:
        call = dataclasses.replace(call,
                                   moe_shard=_moe_shard_fn(cfg, mesh, plan))
    model = build(cfg, call)

    params_shape = _bf16_params(param_shapes(cfg))
    batch_shape = _struct(cfg, shape.global_batch, shape.seq_len)
    pspec = params_pspecs(cfg, params_shape, mesh, plan, client_dim=False)
    bspec = serve_batch_pspecs(batch_shape, mesh, plan)

    def run(params, batch):
        if cache_len is not None:
            return model.prefill_cache(params, batch, cache_len)
        return model.prefill(params, batch)

    with FakeTensorMode():
        fake = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                        (params_shape, batch_shape))
        out_shape = _meta(run(*fake))
    logits_spec = P(tuple(plan.batch), None)
    cache_spec = cache_pspecs(cfg, out_shape[1], mesh, plan)

    def fn(params, batch):
        params = _full_params(mesh, params, params_shape, pspec)
        logits, cache = run(params, _my_rows(mesh, batch, batch_shape,
                                             bspec))
        cache = _relayout(mesh, cache, out_shape[1],
                          tree_map(lambda s: _rows(s, 1), cache_spec),
                          cache_spec)
        return logits, cache

    return BuiltStep(
        fn=fn,
        args=(params_shape, batch_shape),
        in_placements=(_placements(mesh, pspec, params_shape),
                       _placements(mesh, bspec, batch_shape)),
        out_placements=(to_placements(mesh, logits_spec, out_shape[0].shape),
                        _placements(mesh, cache_spec, out_shape[1])),
        meta={"cfg": cfg, "plan": plan, "cache_len": cache_len,
              "param_specs": pspec, "cache_specs": cache_spec},
    )


def build_serve_step(arch: str, shape: ShapeConfig, mesh, *,
                     call: Optional[ModelCallConfig] = None,
                     reduced: bool = False, pos_per_slot: bool = False):
    """ONE-token decode against a seq_len-deep cache: ``fn(params, cache,
    token, pos) -> (logits, cache)`` with ``params`` and ``cache`` this
    rank's blocks, ``token`` (B,) the whole batch's and ``pos`` an int or,
    with ``pos_per_slot``, (B,). Each rank gathers its rows of the cache,
    decodes them and keeps its blocks of the new cache."""
    cfg = get_config(arch, reduced=reduced)
    call = _serve_call(arch, shape, call)
    plan = _serve_plan(arch, mesh)
    if cfg.moe and call.moe_shard is None:
        call = dataclasses.replace(call,
                                   moe_shard=_moe_shard_fn(cfg, mesh, plan))
    model = build(cfg, call)
    B = shape.global_batch

    params_shape = _bf16_params(param_shapes(cfg))
    cache_shape = _meta(model.init_cache(B, shape.seq_len,
                                         torch.device("meta")))
    token_shape = torch.empty((B,), dtype=torch.int32, device="meta")
    pos_shape = torch.empty((B,) if pos_per_slot else (), dtype=torch.int32,
                            device="meta")

    pspec = params_pspecs(cfg, params_shape, mesh, plan, client_dim=False)
    cspec = cache_pspecs(cfg, cache_shape, mesh, plan)
    tok_spec = P(tuple(plan.batch)) if B % _ax(mesh, plan.batch) == 0 \
        else P(None)
    logits_spec = P(tok_spec[0], None)
    pos_spec = tok_spec if pos_per_slot else P()
    rows = tree_map(lambda s: _rows(s, 1), cspec)

    def fn(params, cache, token, pos):
        params = _full_params(mesh, params, params_shape, pspec)
        cache = _relayout(mesh, cache, cache_shape, cspec, rows)
        token = local_shard(token, mesh, to_placements(mesh, tok_spec, (B,)))
        if pos_per_slot:
            pos = local_shard(pos, mesh, to_placements(mesh, tok_spec, (B,)))
        logits, cache = model.decode(params, cache, token, pos)
        return logits, _relayout(mesh, cache, cache_shape, rows, cspec)

    return BuiltStep(
        fn=fn,
        args=(params_shape, cache_shape, token_shape, pos_shape),
        in_placements=(_placements(mesh, pspec, params_shape),
                       _placements(mesh, cspec, cache_shape),
                       to_placements(mesh, tok_spec, (B,)),
                       to_placements(mesh, pos_spec, tuple(pos_shape.shape))),
        out_placements=(to_placements(mesh, logits_spec,
                                      (B, cfg.vocab_size)),
                        _placements(mesh, cspec, cache_shape)),
        donate=(1,),
        meta={"cfg": cfg, "plan": plan, "pos_per_slot": pos_per_slot,
              "decode_window": call.decode_window, "param_specs": pspec,
              "cache_specs": cspec},
    )


def build_step(arch: str, shape_name: str, mesh, **kw):
    shape = get_shape(shape_name)
    if shape.kind == "train":
        return build_train_step(arch, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(arch, shape, mesh, **kw)
    return build_serve_step(arch, shape, mesh, **kw)
