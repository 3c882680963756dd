"""The benchmark's own weights, made on the device from the seed: one
``torch.randn`` over every normally drawn leaf, carved into views and
scaled, the other leaves filled. The same seed on the same device gives
the same weights, so the reference makes them again instead of keeping a
copy beside the program's state.

A spec is a list of ``(path, shape, kind, arg)``: ``path`` a tuple of
keys, ``kind`` one of ``normal`` (times ``arg``), ``ones``, ``zeros`` or
``alog`` (``log(linspace(1, 16, arg))`` in every layer row: mamba2's A).
"""
from __future__ import annotations

import hashlib
import math

import torch


def weight_seed(seed: int) -> int:
    digest = hashlib.blake2b(repr(("perfbench.weights", int(seed))).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def make(spec, seed: int, device) -> dict:
    """The nested dict of fp32 leaves that ``spec`` describes."""
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    normal = [s for s in spec if s[2] == "normal"]
    flat = torch.randn(sum(math.prod(s[1]) for s in normal), generator=gen,
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for path, shape, kind, arg in spec:
        if kind == "normal":
            size = math.prod(shape)
            leaf = flat[off:off + size].view(shape).mul_(arg)
            off += size
        elif kind == "ones":
            leaf = torch.ones(shape, device=device)
        elif kind == "zeros":
            leaf = torch.zeros(shape, device=device)
        elif kind == "alog":
            row = torch.log(torch.linspace(1.0, 16.0, arg, device=device))
            leaf = row.expand(shape).contiguous()
        else:
            raise ValueError(f"unknown init kind {kind!r}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def paths(tree, prefix=()):
    """``[(path, leaf)]`` of a nested dict, keys sorted at every level (the
    order in which both sides list their leaves)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(paths(v, prefix + (k,)))
        elif v is not None:
            out.append((prefix + (k,), v))
    return out
