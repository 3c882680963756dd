"""Device meshes (counterpart of ``repro/launch/mesh.py``).

Functions, so importing this module touches no process group. A mesh is a
``torch.distributed`` ``DeviceMesh`` over the first ``prod(shape)`` ranks of
the default process group (ranks beyond it are not in the mesh), with the
reference's axis names: ``("data", "model")``, or ``("pod", "data",
"model")`` for two pods. The production shapes, (16, 16) and (2, 16, 16),
are the reference's TPU layout. ``device_type`` is ``cuda`` unless the
caller asks for ``cpu``.

Several ranks come from a launcher (``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous) or a test's spawner;
``ensure_process_group`` starts a group of one rank itself when no launcher
set them, so ``python -m repro_torch.launch.train --mesh debug
--mesh-shape 1x1`` runs alone on one card.
"""
from __future__ import annotations

import logging
import math
import os
import tempfile

import torch
import torch.distributed as dist


def ensure_process_group(device_type: str = "cuda") -> bool:
    """Join (or start) the default process group: ``nccl`` for ``cuda``,
    ``gloo`` for ``cpu``. With no ``RANK``/``WORLD_SIZE`` in the
    environment, a group of one rank over a file store in ``TMPDIR``.
    Sets this rank's card (``LOCAL_RANK``) for ``cuda``. Returns whether
    this call started the group (the caller then destroys it)."""
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(path)
        dist.init_process_group(backend, init_method="file://" + path,
                                rank=0, world_size=1)
    return True


def _make(shape, axes, device_type):
    from torch.distributed.device_mesh import DeviceMesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(f"mesh {tuple(shape)} needs {need} ranks, have "
                           f"{have}")
    # DTensor warns at every multi-dim gather; the gathers are intended
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda"):
    """Small mesh for CI-sized runs (ranks permitting)."""
    return _make(tuple(shape), tuple(axes), device_type)
