"""H100 roofline terms of a dry-run record (counterpart of
``benchmarks/roofline.py``'s ``terms``, whose constants are a TPU's).

Every constant is a data-sheet value for one NVIDIA H100 SXM 80GB (HBM3) at
its 700 W power limit, not a measurement; a card set below 700 W runs
slower under load:

* HBM: 3.35e12 B/s, and 80e9 B of it (``fits``);
* fp32 outside the tensor cores: 67e12 FLOP/s (TF32 is off: the attention
  core, which runs in fp32 in every step, and the whole of an fp32 run such
  as ``chip_smoke.py`` phase 15's 1×1 rounds); bf16 dense on the tensor
  cores: 989e12 FLOP/s (the other matmuls of the production train, prefill
  and decode steps, at ``ModelCallConfig``'s bf16 compute dtype);
* NVLink: 450e9 B/s a direction between the 8 GPUs of a node;
* between nodes: 50e9 B/s a GPU (one 400 Gb/s NDR port a GPU).

Ranks map onto nodes in order: node k holds ranks 8k … 8k + 7. A
collective whose group lies in one node moves at the NVLink rate, any other
at the inter-node rate (``utils/cost.py`` splits the bytes so). On the
(16, 16) mesh a ``model`` group (16 consecutive ranks) spans two nodes and
a ``data`` group (stride 16) sixteen: both are priced between nodes.

``terms(rec)`` returns the reference's keys: ``compute_s`` (each dtype's
FLOPs at its peak), ``memory_s``, ``collective_s``, ``dominant``,
``model_flops_per_dev`` (6 · N_active · tokens for a train round, 2 ·
N_active · tokens for a prefill, 2 · N_active · batch for a decode step,
over the devices), ``useful_ratio`` and ``roofline_frac`` (the useful
work's time at the peak of the dtype that does most of the FLOPs, over the
largest term); and ``fits``: the rank's predicted peak within 80e9 B.
``python -m repro_torch.launch.roofline`` prints the records of
``results_torch/dryrun/`` as a markdown table.
"""
from __future__ import annotations

CARD = "NVIDIA H100 SXM 80GB HBM3, 700 W power limit (data sheet)"
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9
NODE_RANKS = 8


def model_flops_per_device(rec) -> float:
    batch, seq = rec["global_batch"], rec["seq_len"]
    n_act, n_dev = rec["active_params"], rec["n_devices"]
    if rec["kind"] == "train":
        return 6.0 * n_act * batch * seq * rec.get("h_local", 8) / n_dev
    if rec["kind"] == "prefill":
        return 2.0 * n_act * batch * seq / n_dev
    return 2.0 * n_act * batch / n_dev


def terms(rec) -> dict:
    by_dtype = rec.get("flops_by_dtype") or {"float32": rec["flops"]}
    comp = sum(v / PEAK_FLOPS.get(k, PEAK_FLOPS["float32"])
               for k, v in by_dtype.items())
    memt = rec["bytes_accessed"] / HBM_BYTES_PER_S
    coll = rec.get("collective_intra_bytes", 0) / NVLINK_BYTES_PER_S \
        + rec.get("collective_inter_bytes", rec["collective_bytes"]) \
        / NETWORK_BYTES_PER_S
    dom = max(("compute", comp), ("memory", memt), ("collective", coll),
              key=lambda kv: kv[1])[0]
    mf = model_flops_per_device(rec)
    main = max(by_dtype, key=by_dtype.get) if by_dtype else "float32"
    bound = max(comp, memt, coll)
    return {
        "compute_s": comp, "memory_s": memt, "collective_s": coll,
        "dominant": dom,
        "model_flops_per_dev": mf,
        "useful_ratio": mf / rec["flops"] if rec["flops"] else 0.0,
        "roofline_frac": (mf / PEAK_FLOPS.get(main, PEAK_FLOPS["float32"]))
        / bound if bound else 0.0,
        "fits": rec.get("peak_bytes", 0) <= HBM_BYTES,
    }


def load(dirname, mesh=None, tag=""):
    """The dry-run records in ``dirname`` (of one mesh, if given), by name."""
    import glob
    import json
    import os
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if "mesh" not in r or (mesh and r["mesh"] != mesh) \
                or (r.get("tag") or "") != tag:
            continue
        recs.append(r)
    return recs


def table(recs) -> str:
    """A markdown table of the records, one row a (arch, shape) pair in
    the reference's order, the values of its meshes joined by " / ": the
    counts a rank, the peak, whether it fits, the dominant term and the
    roofline round time (a model's outputs, not a run)."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    order = lambda r: (ARCH_IDS.index(r["arch"]) if r["arch"] in ARCH_IDS
                       else len(ARCH_IDS), list(INPUT_SHAPES).index(
                           r["shape"]) if r["shape"] in INPUT_SHAPES
                       else len(INPUT_SHAPES), r["n_devices"])
    rows = {}
    for r in sorted(recs, key=order):
        rows.setdefault((r["arch"], r["shape"]), []).append(r)
    lines = ["| arch | shape | mesh | mode | FLOPs | bytes | collective B "
             "| peak GB | fits | dominant | bound s |",
             "|" + "---|" * 11]
    for (arch, shape), rs in rows.items():
        cells = [[] for _ in range(9)]
        for r in rs:
            cells[0].append(r["mesh"])
            if not r["ok"]:
                cells[1].append(f"not run: {r['error']}")
                continue
            t = terms(r)
            for i, v in enumerate((
                    r["mode"], f"{r['flops']:.3e}",
                    f"{r['bytes_accessed']:.3e}",
                    f"{r['collective_bytes']:.3e}",
                    f"{r['peak_bytes'] / 1e9:.1f}",
                    "yes" if t["fits"] else "no", t["dominant"],
                    f"{max(t['compute_s'], t['memory_s'], t['collective_s']):.4g}"),
                    start=1):
                cells[i].append(v)
        lines.append(f"| {arch} | {shape} | " + " | ".join(
            " / ".join(dict.fromkeys(c)) if i in (1, 6, 7) else " / ".join(c)
            for i, c in enumerate(cells)) + " |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="the H100 roofline of the "
                                 "dry run's records, as a markdown table")
    ap.add_argument("--dir", default="results_torch/dryrun")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    recs = load(args.dir, mesh=args.mesh, tag=args.tag)
    print(table(recs))
    ok = [r for r in recs if r["ok"]]
    print(f"\n{len(recs)} records ({len(ok)} ok); dominant terms:",
          {d: sum(1 for r in ok if terms(r)["dominant"] == d)
           for d in ("compute", "memory", "collective")},
          f"; fit 80 GB: {sum(1 for r in ok if terms(r)['fits'])}")


if __name__ == "__main__":
    main()
