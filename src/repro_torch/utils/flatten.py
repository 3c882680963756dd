"""Flat-buffer view of a client-state tree (counterpart of
``repro/utils/flatten.py``).

The fused client loop runs H local steps per round on buffers shaped
``(M, n_total)``: every params/momentum/D leaf reshaped and concatenated into
one contiguous fp32 row per client, so the whole optimizer update is one
kernel launch per local step. ``FlatLayout`` records leaf order, shapes, sizes
and offsets so the tree comes back exactly at the sync barrier. Flatten
copies (``torch.cat``); unflatten returns views into the buffer, so it costs
no memory. Values are never touched, which keeps the flat path equal to the
tree path.

``ShardFlatLayout`` is the counterpart on model-/FSDP-sharded mesh plans:
each rank flattens only its LOCAL leaf shards into an fp32 ``(M, n_local)``
block, and the global flat buffer is the shard-major concatenation of those
blocks (``flatten_ref`` / ``unflatten_ref`` build it without a mesh). A dim
whose extent the shard axes do not divide, or a leaf smaller than one
shard, is replicated in every block. ``ShardedFlatPlan`` bundles the layout
with the mesh, the client axes and the batch axes, and carries the
collectives the engine's round needs on a mesh: each rank of the client
axes runs its own client, and each rank of the shard axes holds one block
of that client's state.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.sharding.partitioner import (PartitionSpec, axis_sizes,
                                              entry_axes, gather,
                                              to_placements)
from repro_torch.utils.tree import (tree_from_paths, tree_leaves, tree_map,
                                    tree_paths, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Layout of a tree flattened into one trailing ``(n_total,)`` axis.

    Built from a tree whose leaves carry ``batch_dims`` leading axes that the
    layout ignores (the client dim M in the engine); ``flatten``/``unflatten``
    keep such axes as leading axes of the flat buffer.
    """
    like: object          # the tree's structure (leaves are placeholders)
    paths: tuple          # '/'-joined key path per leaf, flatten order
    shapes: tuple         # single-replica shape per leaf
    sizes: tuple          # element count per leaf
    offsets: tuple        # start offset of each leaf in the flat axis
    n_total: int

    @classmethod
    def for_tree(cls, tree, batch_dims: int = 0) -> "FlatLayout":
        paths, shapes, sizes, offsets = [], [], [], []
        off = 0
        for path, leaf in tree_paths(tree):
            shape = tuple(leaf.shape[batch_dims:])
            size = math.prod(shape)
            paths.append(path)
            shapes.append(shape)
            sizes.append(size)
            offsets.append(off)
            off += size
        # placeholders, so the layout holds no reference to the tensors
        like = tree_map(lambda _: 0, tree)
        return cls(like=like, paths=tuple(paths), shapes=tuple(shapes),
                   sizes=tuple(sizes), offsets=tuple(offsets), n_total=off)

    def flatten(self, tree, batch_dims: int = 0):
        """Tree with ``batch_dims`` leading axes -> fp32 ``(*batch, n_total)``
        (a new contiguous buffer)."""
        flat = [leaf.reshape(leaf.shape[:batch_dims] + (-1,)).float()
                for leaf in tree_leaves(tree)]
        return torch.cat(flat, dim=-1)

    def unflatten(self, buf, batch_dims: int = 0):
        """``(*batch, n_total)`` -> the tree, as views into ``buf``."""
        batch = tuple(buf.shape[:batch_dims])
        leaves = [buf[..., o:o + s].view(batch + shp)
                  for o, s, shp in zip(self.offsets, self.sizes, self.shapes)]
        return tree_unflatten(self.like, leaves)


def all_float32(tree) -> bool:
    """True iff every leaf is fp32, the fused path's dtype contract."""
    return all(leaf.dtype == torch.float32 for leaf in tree_leaves(tree))


# --------------------------------------------------------------------------- #
# shard-local flat view (model-/FSDP-sharded mesh plans)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ShardFlatLayout:
    """Per-shard flat view of a single-replica tree sharded over ``axes``.

    For each leaf and dim, the dim is split when its spec shards it over a
    subset of ``axes`` whose extent divides it; otherwise (uneven extents,
    leaves smaller than one shard) it is replicated in every shard block.
    The global flat buffer is the shard-major concatenation of the
    per-shard local blocks, ``(*batch, n_shards · n_local)``; shard ``s``
    is the ravel of its coordinates over ``axes``, major first.
    """
    local: FlatLayout                 # layout of ONE shard's local blocks
    axes: Tuple[str, ...]             # shard (model/FSDP) axes, major first
    axis_sizes: Tuple[int, ...]       # mesh extent per axis
    specs: tuple                      # per-leaf effective PartitionSpec
    global_shapes: tuple              # per-leaf single-replica global shape
    split: tuple                      # per-leaf: any dim actually sharded
    uneven: tuple                     # per-leaf: replicated by the fallback

    @property
    def n_shards(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def n_local(self) -> int:
        return self.local.n_total

    @property
    def n_flat(self) -> int:
        return self.n_shards * self.local.n_total

    @classmethod
    def for_tree(cls, tree, pspecs, mesh_shape, axes) -> "ShardFlatLayout":
        """Derive the layout from a SINGLE-REPLICA (shape-)tree: ``pspecs``
        the matching PartitionSpec tree, ``mesh_shape`` a mesh or a mapping
        axis -> extent, ``axes`` the shard axes in flat-axis order."""
        axes = tuple(axes)
        sizes_of = axis_sizes(mesh_shape)
        sizes = tuple(int(sizes_of[a]) for a in axes)
        spec_leaves = tree_leaves(pspecs)
        paths_leaves = tree_paths(tree)
        if len(spec_leaves) != len(paths_leaves):
            raise ValueError(f"pspec tree has {len(spec_leaves)} leaves for "
                             f"{len(paths_leaves)} tree leaves")
        eff_specs, local_shapes, gshapes, split, uneven = [], [], [], [], []
        for (path, leaf), spec in zip(paths_leaves, spec_leaves):
            shape = tuple(leaf.shape)
            entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
            eff, loc, any_split, any_uneven = [], [], False, False
            for dim, entry in zip(shape, entries):
                shard_ax = entry_axes(entry)
                alien = [a for a in shard_ax if a not in axes]
                if alien:
                    raise ValueError(
                        f"leaf {path!r}: spec {spec} uses axis {alien[0]!r} "
                        f"outside the shard axes {axes}")
                ext = math.prod(int(sizes_of[a]) for a in shard_ax)
                if ext > 1 and dim % ext == 0:
                    eff.append(entry)
                    loc.append(dim // ext)
                    any_split = True
                else:
                    any_uneven = any_uneven or ext > 1
                    eff.append(None)
                    loc.append(dim)
            eff_specs.append(PartitionSpec(*eff))
            local_shapes.append(tuple(loc))
            gshapes.append(shape)
            split.append(any_split)
            uneven.append(any_uneven)
        local_tree = tree_unflatten(tree, [
            torch.empty(s, device="meta") for s in local_shapes])
        return cls(local=FlatLayout.for_tree(local_tree), axes=axes,
                   axis_sizes=sizes, specs=tuple(eff_specs),
                   global_shapes=tuple(gshapes), split=tuple(split),
                   uneven=tuple(uneven))

    def flat_spec(self, lead=()) -> PartitionSpec:
        """Spec of the flat buffer: ``lead`` entries then the shard axes."""
        return PartitionSpec(*lead, self.axes)

    def leaf_specs(self, lead=()):
        """PartitionSpec tree of the (possibly batched) leaf tree."""
        return tree_unflatten(self.local.like, [
            PartitionSpec(*lead, *tuple(s)) for s in self.specs])

    # ---- per rank: the local leaf shards <-> the local block ------------- #

    def flatten(self, tree, batch_dims: int = 0):
        """This rank's local leaf shards -> its fp32 ``(*batch, n_local)``
        block; no communication."""
        return self.local.flatten(tree, batch_dims)

    def unflatten(self, buf, batch_dims: int = 0):
        """This rank's block -> its local leaf shards (views into it)."""
        return self.local.unflatten(buf, batch_dims)

    # ---- mesh-free reference ------------------------------------------------ #

    def _shard_slices(self, s: int):
        """Per-leaf index tuples selecting shard ``s``'s local block."""
        coords = np.unravel_index(s, self.axis_sizes) if self.axes else ()
        by_axis = dict(zip(self.axes, (int(c) for c in coords)))
        size_of = dict(zip(self.axes, self.axis_sizes))
        out = []
        for spec, gshape, lshape in zip(self.specs, self.global_shapes,
                                        self.local.shapes):
            idx = []
            entries = tuple(spec) + (None,) * (len(gshape) - len(tuple(spec)))
            for loc, entry in zip(lshape, entries):
                ax = entry_axes(entry)
                if not ax:
                    idx.append(slice(None))
                    continue
                k = 0
                for a in ax:           # major-first ravel over the entry axes
                    k = k * size_of[a] + by_axis[a]
                idx.append(slice(k * loc, (k + 1) * loc))
            out.append(tuple(idx))
        return out

    def flatten_ref(self, tree, batch_dims: int = 0):
        """The global flat buffer without a mesh: the shard-major
        concatenation of every shard's local block."""
        leaves = tree_leaves(tree)
        pre = (slice(None),) * batch_dims
        blocks = []
        for s in range(self.n_shards):
            parts = [leaf[pre + sl].reshape(leaf.shape[:batch_dims] + (-1,))
                     .float()
                     for leaf, sl in zip(leaves, self._shard_slices(s))]
            blocks.append(torch.cat(parts, dim=-1))
        return torch.cat(blocks, dim=-1)

    def unflatten_ref(self, buf, batch_dims: int = 0):
        """Inverse of ``flatten_ref`` (a replicated-in-block leaf takes the
        last block's copy: they agree by contract)."""
        batch = tuple(buf.shape[:batch_dims])
        nl = self.n_local
        leaves = [torch.zeros(batch + s, dtype=torch.float32,
                              device=buf.device) for s in self.global_shapes]
        pre = (slice(None),) * batch_dims
        for s in range(self.n_shards):
            block = buf[..., s * nl:(s + 1) * nl]
            for i, (sl, off, sz, lshape) in enumerate(zip(
                    self._shard_slices(s), self.local.offsets,
                    self.local.sizes, self.local.shapes)):
                leaves[i][pre + sl] = block[..., off:off + sz].reshape(
                    batch + lshape)
        return tree_unflatten(self.local.like, leaves)

    def describe(self) -> dict:
        """JSON-able summary for BuiltStep meta."""
        return {
            "n_shards": self.n_shards,
            "axes": list(self.axes),
            "axis_sizes": list(self.axis_sizes),
            "n_local": self.n_local,
            "n_flat": self.n_flat,
            "leaves": [
                {"path": p, "global_shape": list(g), "local_shape": list(s),
                 "size": sz, "offset": o, "split": bool(sp),
                 "uneven_fallback": bool(un)}
                for p, g, s, sz, o, sp, un in zip(
                    self.local.paths, self.global_shapes, self.local.shapes,
                    self.local.sizes, self.local.offsets, self.split,
                    self.uneven)
            ],
        }


@dataclasses.dataclass(frozen=True)
class RowPart:
    """Rows ``lo:hi`` of a microbatch, this rank's of ``n`` ranks that split
    it; ``sum(x)`` is the sum of ``x`` over those ranks (an all-reduce, a
    new tensor). A client objective scales its rows' term by ``n`` over the
    whole microbatch's normalizer, so that the mean of the ranks' terms is
    the whole microbatch's objective."""
    lo: int
    hi: int
    n: int
    sum: Any

    def rows(self, x):
        return x[self.lo:self.hi]


def _ravel(coord: dict, axes, sizes: dict) -> int:
    k = 0
    for a in axes:
        k = k * sizes[a] + coord[a]
    return k


@dataclasses.dataclass(frozen=True)
class ShardedFlatPlan:
    """What the engine needs to run a round on a mesh: the ``DeviceMesh``,
    the shard-local layout of one replica's params, the client axes (the
    leading M dim; ``None`` for a plan with one client) and the batch axes
    over which a client's microbatch rows are split (``()`` when every rank
    of a client computes its whole microbatch).

    Each rank runs the one client its coordinates on the client axes name,
    and holds that client's leaves as its blocks over the layout's shard
    axes. The methods below are the round's only collectives: a gather of
    a client's params over the shard axes before its forward pass, the
    gradient mean over the batch axes (and an objective's sums there,
    ``row_part``), sums over the client axes (the sync) and global sums
    over the shard axes (every element counted once), and the compression
    of a split leaf's max (``max_shards``) and candidates
    (``gather_shards``) over the shard axes. A group of one rank is never
    called."""
    mesh: Any
    layout: ShardFlatLayout
    client: Any = None
    batch: Tuple[str, ...] = ()

    @classmethod
    def build(cls, mesh, params_one, pspecs_one, axes, client=None,
              batch=()) -> "ShardedFlatPlan":
        """``params_one``/``pspecs_one`` are single-replica (no client dim)."""
        layout = ShardFlatLayout.for_tree(params_one, pspecs_one, mesh,
                                          tuple(axes))
        return cls(mesh=mesh, layout=layout,
                   client=tuple(client) if client else None,
                   batch=tuple(batch))

    # ---- this rank ----------------------------------------------------------- #

    @functools.cached_property
    def _sizes(self) -> dict:
        return axis_sizes(self.mesh)

    @functools.cached_property
    def _coord(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names,
                        self.mesh.get_coordinate()))

    @property
    def client_ranks(self) -> int:
        """The extent of the client axes."""
        return math.prod(self._sizes[a] for a in self.client or ())

    @property
    def client_rank(self) -> int:
        """This rank's index over the client axes (major first): it runs
        clients ``client_rank · m … client_rank · m + m - 1`` of M = m ·
        ``client_ranks``."""
        return _ravel(self._coord, self.client or (), self._sizes)

    @functools.cached_property
    def _by_path(self) -> dict:
        """path -> (effective spec, global shape, this rank's slices,
        whether this rank owns the leaf's elements among the ranks that
        hold copies of them)."""
        lay = self.layout
        s = _ravel(self._coord, lay.axes, self._sizes)
        out = {}
        for path, spec, shape, sl in zip(lay.local.paths, lay.specs,
                                         lay.global_shapes,
                                         lay._shard_slices(s)):
            used = {a for e in spec for a in entry_axes(e)}
            owner = all(self._coord[a] == 0 for a in lay.axes
                        if a not in used)
            out[path] = (spec, shape, sl, owner)
        return out

    def _groups(self, axes):
        return [self.mesh.get_group(a) for a in axes
                if self._sizes[a] > 1]

    # ---- layout of trees of params' paths ---------------------------------- #

    def local_leaf(self, path, leaf, lead: int = 0, client_dim: bool = False):
        """This rank's block of one full leaf at ``path`` (a view; basic
        slicing only, so a numpy array, a memory-mapped file's among
        them, works too)."""
        _, _, sl, _ = self._by_path[path]
        x = leaf[(slice(None),) * lead + sl]
        return self.client_rows(x) if client_dim else x

    def local(self, tree, lead: int = 0, client_dim: bool = False):
        """This rank's blocks of a tree of full leaves (a tree rooted where
        the params are: params, momentum, D, the server's, EF's and FIFO's
        trees) behind ``lead`` leading dims (views). ``client_dim``: the
        first leading dim is the M clients, of which this rank keeps its
        own rows."""
        return tree_from_paths(tree, lambda path, leaf: self.local_leaf(
            path, leaf, lead, client_dim))

    def full_leaf(self, path, leaf, lead: int = 0, client_dim: bool = False):
        """The full leaf at ``path`` of this rank's block (a gather over the
        shard axes, and with ``client_dim`` over the client axes too: the
        first of the ``lead`` dims is then the clients')."""
        spec, shape, _, _ = self._by_path[path]
        head = list(leaf.shape[:lead])
        entries = [None] * lead
        if client_dim:
            head[0] *= self.client_ranks
            entries[0] = self.client
        shape = tuple(head) + shape
        pl = to_placements(self.mesh, PartitionSpec(*entries, *spec), shape)
        return gather(leaf, self.mesh, pl, shape)

    def full(self, tree, lead: int = 0, client_dim: bool = False):
        """``full_leaf`` of every leaf of a tree of this rank's blocks."""
        return tree_from_paths(tree, lambda path, leaf: self.full_leaf(
            path, leaf, lead, client_dim))

    # ---- a leaf's block in the full leaf ----------------------------------- #

    def is_split(self, path) -> bool:
        """Whether the shard axes split the leaf (else every shard rank
        holds it whole). The same on every rank."""
        _, shape, sl, _ = self._by_path[path]
        return any(s != slice(None) for s in sl)

    def full_shape(self, path) -> tuple:
        """The single-replica shape of the full leaf at ``path``."""
        return self._by_path[path][1]

    def first_block(self, path) -> bool:
        """Whether this rank's block of the leaf starts at its first
        element (the block that carries a per-leaf scalar, such as int8's
        scale, once)."""
        _, shape, sl, _ = self._by_path[path]
        return all(s.indices(d)[0] == 0 for s, d in zip(sl, shape))

    def owns(self, path) -> bool:
        """Whether this rank counts the elements of its block of the leaf:
        of the shard ranks that hold copies of a block, one does."""
        return self._by_path[path][3]

    def flat_index(self, path, device=None):
        """The full leaf's flat (C order) index of each element of this
        rank's block, in the block's own C order (int64, increasing: a
        block is a box of the leaf)."""
        _, shape, sl, _ = self._by_path[path]
        idx = torch.zeros((), dtype=torch.int64, device=device)
        for s, dim in zip(sl, shape):
            lo, hi, _ = s.indices(dim)
            idx = idx[..., None] * dim + torch.arange(
                lo, hi, dtype=torch.int64, device=device)
        return idx.reshape(-1)

    # ---- collectives ----------------------------------------------------- #

    def client_rows(self, x):
        """This rank's clients' rows of an (M, ...) tensor (a view)."""
        m = x.shape[0] // self.client_ranks
        return x[self.client_rank * m:(self.client_rank + 1) * m]

    def gather_clients(self, x, dim: int = 0):
        """The M clients' rows of ``x``, whose ``dim`` holds this rank's
        clients (a gather over the client axes)."""
        if not self.client:
            return x
        shape = list(x.shape)
        shape[dim] *= self.client_ranks
        spec = PartitionSpec(*([None] * dim), self.client)
        return gather(x, self.mesh, to_placements(self.mesh, spec, shape),
                      shape)

    def sum_clients(self, x):
        """Σ over the client axes, in place (the sync's all-reduce)."""
        import torch.distributed as dist
        for g in self._groups(self.client or ()):
            dist.all_reduce(x, group=g)
        return x

    def mean_batch(self, tree):
        """The mean over the batch axes of each leaf (a client's gradient
        from its ranks' row slices), in place."""
        import torch.distributed as dist
        groups = self._groups(self.batch)
        if not groups:
            return tree
        n = math.prod(self._sizes[a] for a in self.batch)
        for leaf in tree_leaves(tree):
            for g in groups:
                dist.all_reduce(leaf, group=g)
            leaf.div_(n)
        return tree

    def row_part(self, micro):
        """This rank's share of a client's microbatch for an objective that
        needs the whole microbatch's normalizers: a ``RowPart``, or None
        where the batch axes do not split dim 0 (one rank, or rows that do
        not divide: every rank then computes the whole microbatch)."""
        n = math.prod(self._sizes[a] for a in self.batch)
        rows = tree_leaves(micro)[0].shape[0]
        if n == 1 or rows % n:
            return None
        r = rows // n
        k = _ravel(self._coord, self.batch, self._sizes)
        return RowPart(k * r, (k + 1) * r, n, self._sum_batch)

    def _sum_batch(self, x):
        import torch.distributed as dist
        x = x.clone()
        for g in self._groups(self.batch):
            dist.all_reduce(x, group=g)
        return x

    def batch_rows(self, micro):
        """This rank's rows of a client's microbatch: dim 0 cut over the
        batch axes where it divides, else every row."""
        n = math.prod(self._sizes[a] for a in self.batch)
        if n == 1:
            return micro
        k = _ravel(self._coord, self.batch, self._sizes)

        def one(x):
            if x.dim() == 0 or x.shape[0] % n:
                return x
            r = x.shape[0] // n
            return x[k * r:(k + 1) * r]
        return tree_map(one, micro)

    def sum_shards(self, x):
        """Σ over the shard axes, in place."""
        import torch.distributed as dist
        for g in self._groups(self.layout.axes):
            dist.all_reduce(x, group=g)
        return x

    def max_shards(self, x):
        """The elementwise max over the shard axes, in place (int8's
        per-client scale of a split leaf)."""
        import torch.distributed as dist
        for g in self._groups(self.layout.axes):
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
        return x

    def gather_shards(self, x):
        """Every shard rank's ``x``, concatenated along the last dim (an
        all-gather over each shard axis in turn; top-k's candidates)."""
        import torch.distributed as dist
        x = x.contiguous()
        for g in self._groups(self.layout.axes):
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, x, group=g)
            x = torch.cat(parts, dim=-1)
        return x

    def sum_leaves(self, fn, tree, clients: bool = False):
        """Σ over the leaves of ``fn(block)`` (an fp32 scalar each) over
        the shard axes, every element counted once (a block that several
        shard ranks hold counts on one of them); with ``clients``, also
        summed over the client axes."""
        total = None
        for path, leaf in tree_paths(tree):
            v = fn(leaf)
            if not self.owns(path):
                v = torch.zeros_like(v)
            total = v if total is None else total + v
        self.sum_shards(total)
        return self.sum_clients(total) if clients else total
