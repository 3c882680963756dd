"""The plain reference against the program at a reduced size on the CPU:
whole runs of the harness (set-up, window, check) on tiny cells of the
qwen2 and mamba2 blocks, Adam and OASIS, come out correct; the weights'
spec is the program's tree at full size; the reference imports nothing of
the program, jax or the JAX package."""
from __future__ import annotations

import ast
import json
import os
import time

import pytest

from perfbench import cells, harness
from perfbench.reference import dense, ssm, weights
from perfbench.tests import tiny

LIMITS = {"loss": 1e-5, "mom": 1e-5, "dstat": 1e-5, "change": 1e-5}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tiny.register_archs()
    path = str(tmp_path_factory.mktemp("checkout"))
    tiny.checkout(path, LIMITS)
    return path


def run_cell(root, name, seed=3, trace=False):
    cell = cells.load(root, name, os.path.join(root, "perfbench"))
    return harness.run(cell, seed, 0.0, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_sound_run_is_correct(root, name):
    result, lines = run_cell(root, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 4 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_tok_s", "train_peak_gib",
                                      "setup_s"}
    assert len(lines) == 4 and lines[0].startswith("check loss:")


@pytest.mark.parametrize("config", ["qwen2-0.5b", "mamba2-1.3b.24of48"])
def test_spec_is_the_programs_tree(config):
    from repro_torch import configs
    from perfbench import program
    with open(os.path.join(cells.HERE, "configs", f"{config}.json")) as f:
        conf = json.load(f)
    mod = dense if conf["family"] == "dense" else ssm
    spec = {path: shape for path, shape, _, _ in mod.param_spec(conf)}
    tree = configs.param_shapes(configs.get_config(program.arch_id(conf)))
    got = {path: tuple(leaf.shape) for path, leaf in weights.paths(tree)}
    assert got == spec


def test_reference_imports_no_program():
    folder = os.path.join(cells.HERE, "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module] if isinstance(
                node, ast.ImportFrom) and node.module else []
            for m in mods:
                top = m.split(".")[0]
                assert top in ("torch", "numpy", "hashlib", "math",
                               "__future__", "perfbench"), (name, m)
                assert top != "perfbench" or \
                    m.startswith("perfbench.reference"), (name, m)
