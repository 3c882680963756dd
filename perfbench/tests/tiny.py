"""Tiny cells for the CPU tests: the benchmark's folder copied to a
temporary checkout with a BENCHMARK.json of its own, and two small
architectures registered in the program under ids of their own (the
program's qwen2 and mamba2 at a few dozen widths), so that a test drives a
whole run of the harness on the CPU in seconds.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

DENSE = {"arch": "perfbench-tiny-dense", "family": "dense",
         "source": "https://arxiv.org/abs/2407.10671", "dtype": "float32",
         "tf32": False, "published_layers": 2, "n_layers": 2, "d_model": 64,
         "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab_size": 512,
         "qkv_bias": True, "tie_embeddings": True, "act": "silu",
         "norm_eps": 1e-06, "rope_theta": 1e6, "padded_vocab": 2048,
         "reduced": []}
SSM = {"arch": "perfbench-tiny-ssm", "family": "ssm",
       "source": "https://arxiv.org/abs/2405.21060", "dtype": "float32",
       "tf32": False, "published_layers": 2, "n_layers": 2, "d_model": 64,
       "vocab_size": 512, "tie_embeddings": False, "norm_eps": 1e-06,
       "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 16,
               "chunk": 8, "ngroups": 1},
       "padded_vocab": 2048, "reduced": []}
JOBS = {
    "adam": {"method": "savic", "preconditioner": "adam",
             "scaling": "global", "fused_kernel": True, "clients": 2,
             "h_local": 2, "batch": 2, "seq": 16, "gamma": 0.003,
             "beta1": 0.9, "alpha": 0.01, "beta2": 0.999},
    "oasis": {"method": "savic", "preconditioner": "oasis",
              "scaling": "local", "fused_kernel": True, "clients": 2,
              "h_local": 2, "batch": 2, "seq": 16, "gamma": 0.003,
              "beta1": 0.9, "alpha": 0.01, "beta2": 0.999},
}
CELLS = {"tiny-dense.adam": ("tiny-dense", DENSE, "adam"),
         "tiny-ssm.adam": ("tiny-ssm", SSM, "adam"),
         "tiny-dense.oasis": ("tiny-dense", DENSE, "oasis")}


def register_archs():
    """The two tiny architectures, in the program's registry."""
    from repro_torch import configs
    from repro_torch.configs import SSMConfig
    cfgs = {
        DENSE["arch"]: configs.get_config("qwen2-0.5b").replace(
            name=DENSE["arch"], n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=512),
        SSM["arch"]: configs.get_config("mamba2-1.3b").replace(
            name=SSM["arch"], n_layers=2, d_model=64, vocab_size=512,
            ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                          chunk=8)),
    }
    for arch, cfg in cfgs.items():
        mod = types.ModuleType("repro_torch.configs."
                               + arch.replace("-", "_"))
        mod.CONFIG = mod.REDUCED = cfg
        sys.modules[mod.__name__] = mod
        configs.register(arch, mod.__name__.rsplit(".", 1)[1])


def checkout(root: str, limits: dict) -> str:
    """A temporary checkout at ``root``: the benchmark's folder with the
    tiny cells added, and a BENCHMARK.json naming them; returns the
    folder."""
    folder = os.path.join(root, "perfbench")
    shutil.copytree(BENCH, folder,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(BENCH, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell, (cname, config, job) in CELLS.items():
        _write(folder, "configs", cname, config)
        _write(folder, "traffic", f"tiny.{job}", JOBS[job])
        _write(folder, "workloads", cell,
               {"config": cname, "traffic": f"tiny.{job}",
                "why": "a CPU test", "limits": limits})
        bench["workloads"].append({"name": cell, "config": cname,
                                   "traffic": f"tiny.{job}", "chips": 1,
                                   "why": "a CPU test"})
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + list(CELLS)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return folder


def _write(folder, kind, name, obj):
    with open(os.path.join(folder, kind, f"{name}.json"), "w") as f:
        json.dump(obj, f)
