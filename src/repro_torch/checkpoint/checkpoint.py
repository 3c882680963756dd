"""Pytree checkpoints in the reference's on-disk format (counterpart of
``repro/checkpoint/checkpoint.py``, ``repro-ckpt-v1``).

Layout: ``<dir>/step_<n>/state.msgpack`` holds the manifest (``magic``,
``step``, and per leaf its ``path``, ``shape``, ``dtype``, ``offset`` and
``nbytes``, in that order) and ``data.bin`` the leaves' raw bytes, C order,
in ``tree_paths`` order. The files are byte for byte the reference's for
the same state, and either package reads the other's.

Unlike the reference, which reads the whole ``data.bin`` into host memory,
both ways stream one leaf at a time by offset: host memory stays near the
largest leaf. bf16 moves as its 16-bit pattern, so neither ``ml_dtypes``
nor ``msgpack`` is needed (the manifest goes through ``utils/msgpack.py``).

A mesh run writes the same file, of the full state: ``save`` takes the
full leaves one at a time from the ranks' gathers (``leaves``) and only
one rank writes; on ``restore`` each rank maps ``data.bin`` and copies
only its part of each leaf (``local``), with no collective.
"""
from __future__ import annotations

import math
import os
import shutil

import numpy as np
import torch

from repro_torch.utils import msgpack
from repro_torch.utils.tree import tree_from_paths, tree_paths

_MAGIC = "repro-ckpt-v1"

# manifest dtype name -> (torch dtype, numpy dtype its bytes move as)
_DTYPES = {
    "float32": (torch.float32, np.float32),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, np.int16),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "int32": (torch.int32, np.int32),
    "uint32": (torch.uint32, np.uint32),
    "int64": (torch.int64, np.int64),
    "bool": (torch.bool, np.bool_),
}
_NAME = {t: name for name, (t, _) in _DTYPES.items()}


def _host_bytes(leaf: torch.Tensor):
    """(dtype name, the leaf's bytes as a flat uint8 numpy array)."""
    if leaf.dtype not in _NAME:
        raise TypeError(f"no checkpoint dtype for {leaf.dtype}")
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = np.ascontiguousarray(t.cpu().numpy())
    return _NAME[leaf.dtype], arr.reshape(-1).view(np.uint8)


def save(ckpt_dir: str, step: int, state, keep: int = 3, leaves=None,
         write: bool = True):
    """Write ``state`` as step ``step`` under ``ckpt_dir`` and keep the
    newest ``keep`` steps; returns the step's directory. ``leaves``: an
    iterable of ``(path, full leaf)`` in ``tree_paths`` order that replaces
    ``state``'s own (a mesh rank's ``engine.full_leaves``, each leaf
    gathered when it is taken, so at most one full leaf is alive at a
    time); with ``write`` False every leaf is taken (every rank joins the
    gathers) and nothing is written (returns None)."""
    leaves = tree_paths(state) if leaves is None else leaves
    if not write:
        for _ in leaves:
            pass
        return None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(ckpt_dir, exist_ok=True)
    # a save that crashed mid-write leaves its step_*.tmp dir behind (only a
    # complete tmp is ever renamed into place); reclaim every orphan first
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    os.makedirs(tmp)
    manifest = {"magic": _MAGIC, "step": step, "leaves": []}
    with open(os.path.join(tmp, "data.bin"), "wb") as fb:
        off = 0
        for p, leaf in leaves:
            name, buf = _host_bytes(leaf)
            manifest["leaves"].append({
                "path": p, "shape": list(leaf.shape), "dtype": name,
                "offset": off, "nbytes": buf.size,
            })
            del leaf
            fb.write(buf.data)
            off += buf.size
            del buf
    with open(os.path.join(tmp, "state.msgpack"), "wb") as fm:
        fm.write(msgpack.packb(manifest))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _gc(ckpt_dir, keep)
    return path


def _steps(ckpt_dir: str):
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: int = None, local=None):
    """Restore into the structure of ``template`` (shapes must match): each
    leaf in the checkpoint's dtype, on its template leaf's device. Returns
    (state, step). ``local(path, full leaf) -> this process's part of it``
    (basic slicing, as a mesh rank's ``engine.shard_leaf``): each leaf is
    then mapped from ``data.bin`` and only its part is copied, and
    ``template`` holds the parts' shapes."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "state.msgpack"), "rb") as fm:
        manifest = msgpack.unpackb(fm.read())
    if manifest.get("magic") != _MAGIC:
        raise ValueError(f"{path}: not a {_MAGIC} checkpoint")
    by_path = {l["path"]: l for l in manifest["leaves"]}

    data = os.path.join(path, "data.bin")
    size = os.path.getsize(data)
    with open(data, "rb") as fb:
        def one(p, leaf):
            meta = by_path[p]
            tdtype, ndtype = _DTYPES[meta["dtype"]]
            shape = tuple(meta["shape"])
            if meta["offset"] + meta["nbytes"] > size:
                raise ValueError(f"{p}: data.bin ends inside the leaf")
            if local is not None and math.prod(shape):
                full = np.memmap(data, dtype=ndtype, mode="r",
                                 offset=meta["offset"], shape=shape)
                arr = np.array(local(p, full), order="C")
                del full
            else:
                fb.seek(meta["offset"])
                arr = np.fromfile(fb, dtype=ndtype, count=math.prod(shape))
                if arr.nbytes != meta["nbytes"]:
                    raise ValueError(f"{p}: data.bin ends inside the leaf")
                arr = arr.reshape(shape)
                if local is not None:
                    arr = np.array(local(p, arr), order="C")
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{p}: ckpt {arr.shape} != template "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            if tdtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            return t.to(leaf.device)

        return tree_from_paths(template, one), step


def _gc(ckpt_dir: str, keep: int):
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
