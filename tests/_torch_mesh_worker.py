"""Worker of the port's multi-process mesh tests: starts 4 CPU ranks (gloo,
a file rendezvous in OUTDIR, collectives that time out after 120 s), runs
one suite's cases in every rank and has rank 0 write what they gave to
OUTDIR/<suite>.pt; the test files compare it with the single-device port
and the reference.

  python tests/_torch_mesh_worker.py engine|models OUTDIR

A rank that fails makes the whole run exit non-zero; the tests run it under
their own ``subprocess`` timeout.
"""
import datetime
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 4


def _meshes():
    from repro_torch.launch.mesh import make_debug_mesh
    cache = {}

    def get(shape, axes):
        if (shape, axes) not in cache:
            cache[(shape, axes)] = make_debug_mesh(shape, axes,
                                                   device_type="cpu")
        return cache[(shape, axes)]
    return get


def engine_suite(rank, outdir):
    import _torch_mesh_cases as C
    mesh_of = _meshes()
    out = {}
    for case in C.CASES:
        mesh = mesh_of(case.shape, case.axes)
        if mesh.get_coordinate() is None:
            continue
        plan = C.mlp_shard_plan(case, mesh)
        out[case.id] = {}
        for fused in (False, True):
            calls = []
            with C.record_compression(calls):
                out[case.id][fused] = C.run_port(case, fused, plan)
            if case.knobs in C.FEATURES:
                # every rank holds its own masks; rank 0's counts go out
                out[case.id]["masks", fused] = C.verify_masks(calls)
    mesh = mesh_of((1, 1), ("data", "model"))
    if mesh.get_coordinate() is not None:
        for method in C.ONE_DEVICE_METHODS:
            out["one-device-" + method] = C.quad_run(
                method, True, C.quad_shard_plan(mesh))
    return out


def models_suite(rank, outdir):
    import _torch_mesh_models as MM
    mesh = _meshes()((2, 2), ("data", "model"))
    inputs = torch.load(os.path.join(outdir, "inputs.pt"))
    out = {}
    for arch in MM.ARCHS:
        out[arch] = {fused: MM.mesh_round(arch, inputs[arch], mesh, fused)
                     for fused in (False, True)}
    out["serve"] = MM.mesh_serve(inputs["serve"], mesh)
    out["train_main"] = MM.mesh_train_main()
    out["objective"] = {k: (log, MM.to_numpy(st)) for k, (log, st)
                        in MM.mesh_objective().items()}
    out["ckpt"] = MM.mesh_ckpt(outdir, rank)
    return out


def _rank(rank, suite, outdir):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "rdzv"),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        out = {"engine": engine_suite, "models": models_suite}[suite](
            rank, outdir)
        if rank == 0:
            torch.save(out, os.path.join(outdir, f"{suite}.pt"))
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    suite, outdir = sys.argv[1], sys.argv[2]
    mp.spawn(_rank, args=(suite, outdir), nprocs=WORLD)
    print(f"ALL-OK {suite}")
