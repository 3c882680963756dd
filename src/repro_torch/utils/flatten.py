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

``ShardFlatLayout`` (per-shard buffers on sharded plans) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import (tree_leaves, tree_map, tree_paths,
                                    tree_unflatten)


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
