"""Cost model of the eager program a rank runs (counterpart of
``repro/utils/hlo.py`` and ``repro/utils/hlo_cost.py``, which read XLA's
optimized HLO; the port has no HLO, so this reads the ops themselves).

``CostMode`` is a ``TorchDispatchMode``. Entered inside ``FakeTensorMode``
(the dry run, ``launch/dryrun.py``: shapes only, nothing allocated) or
around real tensors, it records for every op the rank dispatches:

* **FLOPs**: matmul-class ops only, as ``hlo_cost`` counts only ``dot``:
  mm, addmm, bmm, baddbmm, the SDPA ops and convolutions, with
  ``torch.utils.flop_counter``'s formulas (the ones ``FlopCounterMode``
  uses, so a real run under ``FlopCounterMode`` gives the same total).
  Split by the first operand's dtype (``flops_by_dtype``): the port trains
  in fp32 with TF32 off and serves bf16 weights, and the two run at
  different peaks. Elementwise FLOPs are not counted.
* **Bytes**: the eager program's HBM traffic. Each op that is not a view or
  a metadata op (views, ``detach``, ``empty``, ``alias``, shape queries)
  reads its tensor inputs and writes its outputs; an in-place or mutated
  argument counts as read and written; an ``out=`` argument as written.
  A tensor counts the elements its strides reach (a broadcast operand is
  read once). A gather (embedding, ``index_select``, ``index``) reads the
  elements it picks and the indices; a scatter (``index_put_``,
  ``scatter_add_``, ``index_add_``) reads the updates and the indices and
  writes the updated elements, as ``hlo_cost`` counts them. Every op is its own kernel in eager PyTorch, so this is the
  program's true traffic; XLA's count at fusion boundaries has no
  counterpart here.
* **Collectives**: operand bytes and counts by kind with ``hlo.py``'s
  names and conventions (all-gather operand = result / group size,
  reduce-scatter = result · group size, the others = result): the
  ``c10d`` ops (``dist.all_reduce`` and friends) and the functional ones
  (``DTensor``'s gathers). The group is read from the op; its bytes are
  also split by whether the group's ranks lie in one node of
  ``node_ranks`` consecutive ranks (``collective_intra_bytes``) or span
  nodes (``collective_inter_bytes``).
* **An op census**: the ops by count (``op_census``, the top ones), and
  the matmuls' FLOPs by op, dtype and operand shapes
  (``flops_by_matmul``, the top ones).
* **Custom ops by name** (``custom_counts``), each priced by its own byte
  formula (``CUSTOM_BYTES``): K1, ``repro_torch::fused_step_flat``, at
  ``kernels.scaled_update.k1_bytes``, the formula ``chip_smoke.py`` bounds
  it with.
* **Live bytes and their peak**: each storage an op creates counts from
  its creation until it is freed (a weak reference on the storage); the
  arguments count from ``track``; a ``meta`` tensor (the mesh code's
  stride queries) holds nothing. Under ``FakeTensorMode`` this is the
  rank's predicted peak of allocated memory (the caching allocator's
  rounding and the libraries' workspaces are not in it).

Counters are plain numbers (``totals()``), so two traces can be added,
subtracted and scaled (``combine``): the dry run prices H identical local
steps from traces of two and three.
"""
from __future__ import annotations

import math
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# collective ops: name -> (kind, where its operand is: "in" the tensor
# arguments but the first (the c10d *_base_ ops take the output first),
# "all" of them, or "first" alone)
COLLECTIVES = {
    "c10d.allreduce_": ("all-reduce", "all"),
    "c10d.allreduce_coalesced_": ("all-reduce", "all"),
    "_c10d_functional.all_reduce": ("all-reduce", "first"),
    "_c10d_functional.all_reduce_": ("all-reduce", "first"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "all"),
    "c10d._allgather_base_": ("all-gather", "in"),
    "c10d.allgather_": ("all-gather", "in"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "in"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "first"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather",
                                                          "all"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "in"),
    "c10d.reduce_scatter_": ("reduce-scatter", "in"),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", "in"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "first"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "all"),
    "c10d.alltoall_base_": ("all-to-all", "in"),
    "c10d.alltoall_": ("all-to-all", "in"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "first"),
    "c10d.broadcast_": ("broadcast", "all"),
    "_c10d_functional.broadcast": ("broadcast", "first"),
    "_c10d_functional.broadcast_": ("broadcast", "first"),
}

# ops that move no bytes: views, aliases, allocation without a fill, and
# metadata queries (``OpOverload.is_view`` covers the rest of the views)
FREE = {
    "aten.detach", "aten.alias", "aten.lift_fresh", "aten._unsafe_view",
    "aten.empty", "aten.empty_like", "aten.empty_strided",
    "aten.new_empty", "aten.new_empty_strided", "aten.resize_",
    "aten._local_scalar_dense", "aten.sym_size", "aten.sym_stride",
    "aten.sym_numel", "aten.sym_storage_offset", "aten.is_contiguous",
    "aten.set_", "_c10d_functional.wait_tensor", "c10d.barrier",
    "c10d.monitored_barrier_",
}


# ops that read only what they pick: the source's picked elements (as many
# as the output) and the indices, then the output is written
GATHERS = {"aten.embedding", "aten.index_select", "aten.index",
           "aten.gather", "aten.take_along_dim"}
# in-place scatters: the updates (argument index) and the indices are read,
# the updated elements written; the rest of the destination is untouched
SCATTERS = {"aten.index_put_": 2, "aten.index_put": 2, "aten.scatter_": 3,
            "aten.scatter_add_": 3, "aten.scatter_add": 3,
            "aten.index_add_": 3, "aten.index_add": 3,
            "aten.index_copy_": 3}


def k1_op_bytes(args):
    """K1's bytes from the operator's arguments (``k1_bytes``)."""
    from repro_torch.kernels.scaled_update import k1_bytes
    p, d, h, update_d = args[0], args[3], args[4], args[15]
    M, n = p.shape
    mode = None if d is None else ("local" if d.dim() == 2 else "global")
    return k1_bytes(M, n, mode, h is not None, update_d)


CUSTOM_BYTES = {"repro_torch.fused_step_flat": k1_op_bytes}


def tensor_bytes(t) -> int:
    """Bytes of the elements ``t``'s strides reach (a broadcast view's
    stride-0 dims count once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _group_ranks(args):
    """The ranks of the process group a collective's arguments name."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.get_process_group_ranks(
                    dist.ProcessGroup.unbox(a))
            except Exception:       # a ReduceOp, not the group
                continue
    name = args[-1]
    return dist.get_process_group_ranks(c10d._resolve_process_group(name))


class CostMode(TorchDispatchMode):
    """Counts what the ops dispatched under it cost (module docstring)."""

    def __init__(self, node_ranks: int = 8):
        super().__init__()
        self.node_ranks = node_ranks
        self.flops_by_dtype = defaultdict(int)
        self.bytes = 0
        self.coll_by_kind = defaultdict(int)
        self.coll_counts = defaultdict(int)
        self.coll_intra = 0
        self.coll_inter = 0
        self.census = Counter()
        self.matmuls = Counter()
        self.custom_counts = Counter()
        self.live = 0
        self.peak = 0
        self._live = {}

    # ---- live bytes ---------------------------------------------------- #

    def track(self, tree):
        """Count the storages of ``tree``'s tensors as live (arguments)."""
        for t in _tensors(tree):
            self._hold(t)

    def _hold(self, t):
        if t.device.type == "meta":
            return                  # shape only (a stride query): no memory
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(key=key, n=n, ref=weakref.ref(self)):
            mode = ref()
            if mode is not None and mode._live.pop(key, None) is not None:
                mode.live -= n
        self._live[key] = weakref.finalize(st, free)

    def _release(self, t):
        st = t.untyped_storage()
        fin = self._live.pop(id(st), None)
        if fin is not None and fin.detach() is not None:
            self.live -= st.nbytes()

    # ---- the ops --------------------------------------------------------- #

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket) if hasattr(func, "overloadpacket") \
            else str(func)
        if name.startswith("prim."):
            return out
        self.census[name] += 1
        if name == "_c10d_functional.wait_tensor":
            # the real op returns its input, a fake one a new tensor: the
            # input's storage is counted as the output's from here on
            self._release(args[0])
        for t in _tensors(out):
            self._hold(t)
        if name in COLLECTIVES:
            self._collective(name, args, kwargs)
        if name in CUSTOM_BYTES:
            self.custom_counts[name] += 1
            self.bytes += CUSTOM_BYTES[name](args)
            return out
        packet = func.overloadpacket
        from torch.utils.flop_counter import flop_registry
        if packet in flop_registry:
            ts = _tensors(args)
            dt = str(ts[0].dtype).replace("torch.", "")
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops_by_dtype[dt] += f
            sig = " ".join([name.split(".")[-1], dt] + [
                "x".join(map(str, t.shape)) for t in ts[:3]])
            self.matmuls[sig] += f
        if name in FREE or func.is_view:
            return out
        self.bytes += self._op_bytes(func, args, kwargs, out)
        return out

    def _op_bytes(self, func, args, kwargs, out):
        name = str(func.overloadpacket)
        index = lambda: sum(tensor_bytes(t) for t in _tensors(list(args))
                            if not t.is_floating_point())
        if name in GATHERS:
            return 2 * sum(tensor_bytes(t) for t in _tensors(out)) + index()
        if name in SCATTERS:
            upd = args[SCATTERS[name]]
            upd = sum(tensor_bytes(t) for t in _tensors(upd))
            return 2 * upd + index()
        reads = 0
        schema = func._schema.arguments
        for i, arg in enumerate(schema):
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            if val is None:
                continue
            write_only = arg.kwarg_only and arg.alias_info is not None \
                and arg.alias_info.is_write
            if not write_only:
                reads += sum(tensor_bytes(t) for t in _tensors(val))
        writes = sum(tensor_bytes(t) for t in _tensors(out))
        return reads + writes

    def _collective(self, name, args, kwargs):
        kind, where = COLLECTIVES[name]
        ts = _tensors(list(args))
        if where == "in":
            ts = _tensors(args[1]) if len(args) > 1 else []
        elif where == "first":
            ts = ts[:1]
        nbytes = sum(tensor_bytes(t) for t in ts)
        ranks = _group_ranks(list(args) + list(kwargs.values()))
        self.coll_by_kind[kind] += nbytes
        self.coll_counts[kind] += 1
        if len({r // self.node_ranks for r in ranks}) == 1:
            self.coll_intra += nbytes
        else:
            self.coll_inter += nbytes

    # ---- results --------------------------------------------------------- #

    def totals(self) -> dict:
        """The additive counters as a flat dict of numbers."""
        out = {"bytes": self.bytes,
               "collective_intra_bytes": self.coll_intra,
               "collective_inter_bytes": self.coll_inter}
        for k, v in self.flops_by_dtype.items():
            out[f"flops:{k}"] = v
        for k, v in self.coll_by_kind.items():
            out[f"coll_bytes:{k}"] = v
        for k, v in self.coll_counts.items():
            out[f"coll_count:{k}"] = v
        for k, v in self.census.items():
            out[f"op:{k}"] = v
        for k, v in self.custom_counts.items():
            out[f"custom:{k}"] = v
        for k, v in self.matmuls.items():
            out[f"matmul:{k}"] = v
        return out


def combine(*terms):
    """Σ c · t over ``(c, totals)`` pairs, key by key."""
    out = defaultdict(int)
    for c, t in terms:
        for k, v in t.items():
            out[k] += c * v
    return dict(out)


def summary(t: dict, top: int = 15) -> dict:
    """The record's cost keys from a totals dict: ``flops``,
    ``flops_by_dtype``, ``bytes_accessed``, ``collective_bytes``,
    ``collective_by_kind``, ``collective_counts``, the intra-/inter-node
    split, ``custom_counts``, and the top ``op_census`` and
    ``flops_by_matmul``."""
    part = lambda pre: {k[len(pre):]: v for k, v in t.items()
                        if k.startswith(pre) and v}
    fl, ck = part("flops:"), part("coll_bytes:")
    census, mm = part("op:"), part("matmul:")
    return {
        "flops": sum(fl.values()),
        "flops_by_dtype": fl,
        "bytes_accessed": t.get("bytes", 0),
        "collective_bytes": sum(ck.values()),
        "collective_by_kind": ck,
        "collective_counts": part("coll_count:"),
        "collective_intra_bytes": t.get("collective_intra_bytes", 0),
        "collective_inter_bytes": t.get("collective_inter_bytes", 0),
        "custom_counts": part("custom:"),
        "op_census": dict(sorted(census.items(),
                                 key=lambda kv: (-kv[1], kv[0]))[:top]),
        "flops_by_matmul": dict(sorted(mm.items(),
                                       key=lambda kv: (-kv[1], kv[0]))[:top]),
    }
