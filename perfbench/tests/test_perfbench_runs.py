"""The run as a command, and the harness driven by data: a run refuses
without a card or without the program, the no-JAX check compares whole
top-level names, and a configuration, a traffic mix, a cell and a
per-layer metric are added by adding files."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import cells, harness
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_reference import LIMITS  # noqa: F401

ROOT = os.path.dirname(cells.HERE)
CMD = [sys.executable, "perfbench/run.py", "--workload",
       "qwen2-0.5b.savic-adam.s1024", "--seed", "2147483999", "--seconds",
       "1", "--trace", "0"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        return
    out = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                         env=_env(), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                         env=_env(), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules():
    ok = ["repro_torch", "repro_torch.core.engine", "torch", "reprox"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["repro.core"]) == ["repro"]
    assert harness.forbidden_modules(ok + ["jax.numpy"]) == ["jax"]
    assert harness.forbidden_modules(["jaxlib", "flax.linen"]) == [
        "flax", "jaxlib"]


def test_added_by_files(tmp_path):
    """A new metric, read from the traced window, reaches the result line
    of a new cell without an edit to the harness."""
    tiny.register_archs()
    folder = tiny.checkout(str(tmp_path), LIMITS)
    with open(os.path.join(folder, "metrics", "rounds_traced.py"),
              "w") as f:
        f.write('LAYER = "the whole round"\nMOVES = "train_tok_s"\n'
                'UNIT = "rounds"\n\n\ndef read(ctx):\n'
                '    return float(ctx.rounds)\n')
    bench_path = tmp_path / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["per_layer"].append({
        "name": "rounds_traced", "unit": "rounds", "better": "higher",
        "source": "program_counter", "layer": "the whole round",
        "moves": "train_tok_s", "workloads": ["tiny-ssm.adam"]})
    bench_path.write_text(json.dumps(bench))
    from perfbench import trace
    cell = cells.load(str(tmp_path), "tiny-ssm.adam", folder)
    result, _ = harness.run(cell, 9, 0.0, True, "cpu", time.perf_counter())
    assert result["metrics"]["rounds_traced"]["value"] == trace.TRACE_ROUNDS
    assert "batch_host_ms" in result["metrics"]
    # device readers find nothing on the CPU and are left out
    assert "device_idle_pct" not in result["metrics"]
    assert result["correct"]


def test_trace_reduce():
    """Busy time is the union of the device intervals in the window, the
    spans' device-side copies are not device work, and each idle gap is
    named by the innermost host operation open when it began (over both
    host threads)."""
    from perfbench import trace
    ev = [("perfbench.window", 0, 100, False, 1, True),
          ("perfbench.round", 2, 90, False, 1, True),
          ("perfbench.round", 3, 95, True, 0, True),
          ("aten::mm", 5, 20, False, 1, False),
          ("aten::add", 33, 45, False, 2, False),
          ("gemm_a", 10, 30, True, 0, False),
          ("gemm_b", 25, 35, True, 0, False),
          ("fused_step_vec4", 44, 60, True, 0, False),
          ("before_window", -10, -5, True, 0, False)]
    tr = trace.reduce(ev, 1, {"batch": [0.01]})
    assert tr.window_s == 100e-9 and tr.busy_s == pytest.approx(41e-9)
    assert [k for k, _ in tr.kernels] == ["gemm_a", "gemm_b",
                                          "fused_step_vec4"]
    gaps = dict(tr.breakdown["idle_gaps"])
    assert gaps["host (no operation)"] == pytest.approx(10e-9)
    assert gaps["aten::add"] == pytest.approx(9e-9)
    assert gaps["perfbench.round"] == pytest.approx(40e-9)


def test_nan_gap_fails():
    """A gap that is not a number fails the check, wherever it lies among
    the leaves (``max`` alone would pass over it)."""
    from perfbench import check
    leaves = {("a",): 1.0, ("b",): 2.0, ("c",): 3.0}
    ref = {"losses": [1.0], "mom": leaves, "dstat": leaves,
           "change": leaves}
    prog = dict(ref, mom={("a",): 1.0, ("b",): float("nan"), ("c",): 3.0})
    ok, checks, at = check.compare(prog, ref, dict.fromkeys(check.NUMBERS,
                                                            1e-3))
    assert not ok and at["mom"] == "b"
    assert check.compare(ref, ref, dict.fromkeys(check.NUMBERS, 0.0))[0]
