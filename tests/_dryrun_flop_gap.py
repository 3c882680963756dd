"""FLOPs a device of the reference's dry run against FLOPs a rank of the
port's, matmul by matmul: qwen2-0.5b ``train_4k`` on the (16, 16) mesh in
``paper`` mode, at full width cut to ``--layers`` layers (the per-layer
matmuls repeat, so the gap per layer is the gap), H local steps.

The reference's step is lowered and compiled on 256 fake XLA host devices
and each ``dot`` of its optimized HLO is counted as ``hlo_cost.analyze``
counts it (trip counts applied); the port's round is traced by its dry run
(``flops_by_matmul``). Nothing is allocated on either side.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_dryrun_flop_gap.py \\
      --layers 2 --h 2
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import jax  # noqa: E402


def reference_dots(layers, H):
    """(total FLOPs, Counter of 'lhs -> result' shapes) a device."""
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_production_mesh
    from repro.utils import hlo_cost as hc
    orig = jsteps.get_config
    jsteps.get_config = lambda arch, reduced=False: orig(
        arch, reduced).replace(n_layers=layers)
    mesh = make_production_mesh(multi_pod=False)
    b = jsteps.build_step("qwen2-0.5b", "train_4k", mesh, mode="paper",
                          h_local=H)
    with mesh:
        hlo = jax.jit(b.fn, in_shardings=b.in_shardings,
                      out_shardings=b.out_shardings,
                      donate_argnums=b.donate).lower(
            *b.args).compile().as_text()
    jsteps.get_config = orig
    comps = hc._parse(hlo)
    mult, _, _ = hc._multipliers(comps)
    shapes = {ins.name: hc._SHAPE_TOKEN.findall(ins.type_text)
              for c in comps.values() for ins in c.instrs}
    dots, total = Counter(), 0.0
    for comp in comps.values():
        m = mult.get(comp.name, 0.0)
        for ins in comp.instrs:
            if m == 0.0 or ins.opcode != "dot":
                continue
            lhs = ins.operands[0]
            dims = [int(d) for d in shapes[lhs][0][1].split(",") if d]
            cm = hc._CONTRACT.search(ins.rest)
            cdim = 1
            for ci in (cm.group(1).split(",") if cm else []):
                if ci:
                    cdim *= dims[int(ci)]
            out = sum(hc._shape_elems(d) for _, d in shapes[ins.name])
            f = m * 2.0 * out * cdim
            total += f
            res = shapes[ins.name][0]
            dots[f"{res[0]}[{','.join(map(str, dims))}]->[{res[1]}]"] += f
    return total, dots


def port_matmuls(layers, H):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    orig = steps.get_config
    steps.get_config = lambda arch, reduced=False: get_config(
        arch, reduced).replace(n_layers=layers)
    try:
        rec = dryrun.run_one("qwen2-0.5b", "train_4k", h_local=H,
                             save=False, verbose=False)
    finally:
        steps.get_config = orig
    return rec["flops"], rec["flops_by_matmul"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--h", type=int, default=2)
    args = ap.parse_args(argv)
    ref_total, dots = reference_dots(args.layers, args.h)
    port_total, mms = port_matmuls(args.layers, args.h)
    print(json.dumps({
        "layers": args.layers, "h_local": args.h,
        "reference_flops_per_device": ref_total,
        "port_flops_per_rank": port_total,
        "ratio": port_total / ref_total,
        "reference_dots": dict(dots.most_common(24)),
        "port_matmuls": mms}, indent=1))


if __name__ == "__main__":
    main()
