"""Sharding rules: params / optimizer state / batches / caches ->
``PartitionSpec`` -> ``DTensor`` placements (counterpart of
``repro/sharding/partitioner.py``).

Axis semantics: mesh axes are partitioned into ``client`` axes (SAVIC
clients; cross-client traffic only at the sync), ``batch`` axes (intra-client
data parallel / FSDP) and ``model`` axes (tensor / expert parallel inside a
replica). The rules are the reference's ``_param_spec``, path for path and
in the same order, over the same '/'-joined parameter paths; a dim is only
sharded when its extent divides by the mesh axes' extent.

``PartitionSpec`` is the port's own: one entry per dim, ``None`` or a tuple
of mesh-axis names (major first). ``to_placements`` turns a spec into one
``DTensor`` placement per mesh dim:

* a dim sharded over several axes jointly is ``Shard(d)`` on each of those
  mesh dims; ``DTensor`` nests such shards in mesh-dim order, so the entry
  must list its axes in mesh order (else ``ValueError``);
* a dim whose extent the axes do not divide is ``Replicate`` (the
  ``ShardFlatLayout`` fallback), never ``DTensor``'s uneven ``Shard``.

``local_shard`` cuts a rank's block out of a full tensor (no
communication); ``gather`` is the inverse, a ``DTensor.full_tensor`` over
the mesh dims that shard the tensor. Mesh dims the placements call
``Replicate`` move nothing, so a per-client tensor (different on every
client rank) can be gathered over its model shards alone.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_from_paths


class PartitionSpec:
    """One entry per dim: ``None`` or a tuple of mesh-axis names. A tree
    leaf (not a tuple), so the port's tree helpers stop at it."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return "PartitionSpec" + repr(self.entries)


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """Axis name -> extent, of a ``DeviceMesh`` or of anything whose
    ``shape`` is such a mapping (or of the mapping itself)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


def entry_axes(entry) -> tuple:
    """Spec entry -> tuple of mesh-axis names (major first)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    """How mesh axes are assigned to roles for a given run mode."""
    client: Tuple[str, ...] = ()      # SAVIC client axes (M = prod of sizes)
    batch: Tuple[str, ...] = ()       # intra-client DP/FSDP axes
    model: Tuple[str, ...] = ("model",)
    fsdp_params: bool = False         # additionally shard params over batch

    def clients(self, mesh) -> int:
        return _axsize(mesh, self.client)


def plan_for(mode: str, multi_pod: bool) -> AxisPlan:
    """Canonical plans. mode: paper | paper_fsdp | diloco | plain."""
    if mode == "paper":
        client = ("pod", "data") if multi_pod else ("data",)
        return AxisPlan(client=client, batch=(), model=("model",))
    if mode == "paper_fsdp":
        # clients on data(+pod); inside a client the "model"-axis devices
        # run batch-parallel + FSDP instead of tensor parallel
        client = ("pod", "data") if multi_pod else ("data",)
        return AxisPlan(client=client, batch=("model",), model=(),
                        fsdp_params=True)
    if mode == "diloco":
        if not multi_pod:
            raise ValueError("diloco mode needs the multi-pod mesh (client=pod)")
        return AxisPlan(client=("pod",), batch=("data",), model=("model",))
    if mode == "plain":
        batch = ("pod", "data") if multi_pod else ("data",)
        return AxisPlan(client=(), batch=batch, model=("model",),
                        fsdp_params=True)
    raise ValueError(mode)


def _axsize(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _maybe(axes: Sequence[str], dim: int, mesh):
    """Return the axes tuple if dim divides by their extent, else None."""
    if not axes:
        return None
    return tuple(axes) if dim % _axsize(mesh, axes) == 0 else None


def _param_spec(path: str, shape, cfg, mesh, plan: AxisPlan, stacked: bool,
                client_dim: bool) -> PartitionSpec:
    """PartitionSpec for one parameter leaf. ``stacked``: leading layer dim
    (inside blocks/stack). ``client_dim``: leading SAVIC client dim."""
    mdl = plan.model
    fsdp = plan.batch if plan.fsdp_params else ()

    lead = []
    if client_dim:
        lead.append(tuple(plan.client) if plan.client else None)
    core = list(shape[len(lead):])
    if stacked:
        lead.append(None)               # the layer dim is never sharded
        core = core[1:]

    def spec(*dims):
        return P(*lead, *dims)

    nd = len(core)
    # ---- rules (most specific first) ---------------------------------------
    if re.search(r"experts/(wg|wu)$", path):        # (E, d, f)
        e = _maybe(mdl, core[0], mesh)
        if e:
            return spec(e, _maybe(fsdp, core[1], mesh), None)
        return spec(None, _maybe(fsdp, core[1], mesh),
                    _maybe(mdl, core[2], mesh))
    if re.search(r"experts/wd$", path):             # (E, f, d)
        e = _maybe(mdl, core[0], mesh)
        if e:
            return spec(e, None, _maybe(fsdp, core[2], mesh))
        return spec(None, _maybe(mdl, core[1], mesh),
                    _maybe(fsdp, core[2], mesh))
    if re.search(r"router/w$", path):               # (d, E) replicate
        return spec(None, None)
    if re.search(r"(wq_b|wk_b|wv_b)/w$", path) and nd == 3:  # MLA (r, H, n)
        return spec(None, _maybe(mdl, core[1], mesh), None)
    if re.search(r"(wq|wk|wv)/w$", path) and nd == 3:   # (d, H, hd)
        return spec(_maybe(fsdp, core[0], mesh), _maybe(mdl, core[1], mesh),
                    None)
    if re.search(r"(wq|wk|wv)/b$", path) and nd == 2:   # (H, hd)
        return spec(_maybe(mdl, core[0], mesh), None)
    if re.search(r"wo/w$", path) and nd == 3:           # (H, hd, d)
        return spec(_maybe(mdl, core[0], mesh), None,
                    _maybe(fsdp, core[2], mesh))
    if re.search(r"embed/(table)$", path):          # (V, d)
        return spec(_maybe(mdl, core[0], mesh), _maybe(fsdp, core[1], mesh))
    if re.search(r"embed/head$", path):             # (d, V)
        return spec(_maybe(fsdp, core[0], mesh), _maybe(mdl, core[1], mesh))
    if re.search(r"(wq|wq_b|wk_b|wv_b|wg|wu|wx|wz)/w$", path):  # (d_in, big)
        return spec(_maybe(fsdp, core[0], mesh), _maybe(mdl, core[1], mesh))
    if re.search(r"(wk|wv)/w$", path):              # kv proj
        return spec(_maybe(fsdp, core[0], mesh), _maybe(mdl, core[1], mesh))
    if re.search(r"(wo|wd)/w$", path):              # (big, d)
        return spec(_maybe(mdl, core[0], mesh), _maybe(fsdp, core[1], mesh))
    if re.search(r"(wq_a|wkv_a|wB|wC|wdt)/w$", path):  # (d, small)
        return spec(_maybe(fsdp, core[0], mesh), None)
    if re.search(r"conv_x$", path):                 # (d_in, K)
        return spec(_maybe(mdl, core[0], mesh), None)
    return spec(*([None] * nd))


def params_pspecs(cfg, params_shape, mesh, plan: AxisPlan, client_dim: bool):
    """PartitionSpec tree matching a params (shape-)tree."""
    def one(path, leaf):
        stacked = "/stack/" in f"/{path}/"
        return _param_spec(path, tuple(leaf.shape), cfg, mesh, plan, stacked,
                           client_dim)
    return tree_from_paths(params_shape, one)


def batch_pspecs(batch_shape, mesh, plan: AxisPlan, client_dim: bool,
                 has_h_dim: bool = True):
    """SAVIC round batch (M, H, b, ...): client dim over client axes, H
    never sharded, the per-client batch dim b over batch axes."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        dims = []
        if client_dim:
            dims.append(tuple(plan.client) if plan.client else None)
        if has_h_dim:
            dims.append(None)
        i = len(dims)
        if len(shape) > i:
            dims.append(_maybe(plan.batch, shape[i], mesh))
        dims += [None] * (len(shape) - len(dims))
        return P(*dims)
    return tree_from_paths(batch_shape, one)


def serve_batch_pspecs(batch_shape, mesh, plan: AxisPlan):
    """Serving inputs: batch dim over (client + batch) axes jointly if
    divisible, else replicated."""
    axes = tuple(plan.client) + tuple(plan.batch)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        dims = [_maybe(axes, shape[0], mesh)] if shape else []
        dims += [None] * (len(shape) - len(dims))
        return P(*dims)
    return tree_from_paths(batch_shape, one)


def cache_pspecs(cfg, cache_shape, mesh, plan: AxisPlan):
    """Decode caches, (L, B, S, H, D) or mamba state trees: batch over
    (client + batch) axes when divisible, else the sequence dim; heads /
    state over model axes when divisible."""
    daxes = tuple(plan.client) + tuple(plan.batch)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if "mamba" in path:
            dims = [None, _maybe(daxes, shape[1], mesh)]
            if "h" in path.split("/")[-1] and nd >= 3:
                dims.append(_maybe(plan.model, shape[2], mesh))
            dims += [None] * (nd - len(dims))
            return P(*dims)
        if nd >= 4:
            b = _maybe(daxes, shape[1], mesh)
            s = None if b else _maybe(daxes, shape[2], mesh)
            h = _maybe(plan.model, shape[3], mesh)
            return P(*([None, b, s, h] + [None] * (nd - 4)))
        if nd == 3:
            b = _maybe(daxes, shape[1], mesh)
            s = None if b else _maybe(daxes, shape[2], mesh)
            return P(None, b, s)
        return P(*([None] * nd))
    return tree_from_paths(cache_shape, one)


def opt_state_like_params(pspecs):
    """Optimizer state (momentum, preconditioner stats) shards like params."""
    return pspecs


# --------------------------------------------------------------------------- #
# DTensor placements
# --------------------------------------------------------------------------- #


def to_placements(mesh, spec, shape) -> tuple:
    """One ``DTensor`` placement per mesh dim for a tensor of ``shape``
    laid out by ``spec`` (see the module docstring for the three rules)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for d, (dim, entry) in enumerate(zip(shape, entries)):
        axes = entry_axes(entry)
        if not axes:
            continue
        ext = math.prod(sizes[a] for a in axes)
        if ext > 1 and dim % ext:
            continue                    # uneven: replicated on every shard
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: entry {entry} lists its axes out "
                             f"of mesh order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(d)
    return tuple(out)


def local_shard(full, mesh, placements):
    """This rank's block of ``full`` under ``placements`` (a view; nested
    shards cut in mesh-dim order, as ``DTensor`` lays them out)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    sizes = mesh.mesh.shape
    x = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and sizes[i] > 1:
            n = x.shape[pl.dim] // sizes[i]
            x = x.narrow(pl.dim, coord[i] * n, n)
    return x


def gather(local, mesh, placements, shape):
    """The full tensor of ``shape`` whose blocks the ranks hold as
    ``local`` (collective over the mesh dims that shard it)."""
    from torch.distributed.tensor import DTensor, Shard
    sizes = mesh.mesh.shape
    if not any(isinstance(pl, Shard) and sizes[i] > 1
               for i, pl in enumerate(placements)):
        return local
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    dt = DTensor.from_local(local.contiguous(), mesh, placements,
                            run_check=False, shape=shape, stride=stride)
    return dt.full_tensor()
