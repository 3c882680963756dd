"""The port's training CLI against the reference's, plus the port's guards.

``repro_torch.launch.train.main(... --device cpu --reduced)`` starts from the
reference's initial weights (passed through ``repro_torch.bridge``) and must
log the same per-round loss (1e-5 relative), client drift (1e-4 relative: a
sum of squares of differences of nearly equal params) and adaptive-server
step norm (1e-3 relative: built from Δ = x' − x, which cancels) as
``repro.launch.train.main``.
"""
import ast
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro_torch.bridge import params_from_jax
from repro_torch.launch import train

torch.set_num_threads(1)

BASE = ["--arch", "qwen2-0.5b", "--reduced", "--rounds", "2", "--h-local",
        "2", "--clients", "2", "--batch", "1", "--seq", "16"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_init(seed=0):
    cfg = jget_config("qwen2-0.5b", reduced=True)
    import jax.numpy as jnp
    params = jbuild(cfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(seed))
    np_params = jax.device_get(params)
    return lambda gen: params_from_jax(np_params, gen.device)


@pytest.mark.parametrize("method,fused", [
    ("savic", True), ("local-adam", True), ("fedadam", False),
], ids=["savic-fused", "local-adam-fused", "fedadam-tree"])
def test_train_main_matches_reference(method, fused):
    """The reference runs its tree path (its own tests pin its fused path
    bitwise to it, and the tree path skips the Pallas interpreter)."""
    extra = ["--method", method]
    want = jtrain.main(BASE + extra)
    got = train.main(BASE + extra + ["--device", "cpu"]
                     + (["--use-fused-kernel"] if fused else []),
                     init_params=_reference_init())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["drift"], w["drift"], rtol=1e-4)
        assert ("step_norm" in g) == ("step_norm" in w)
        if "step_norm" in w:
            np.testing.assert_allclose(g["step_norm"], w["step_norm"],
                                       rtol=1e-3)
        assert g["sim_time"] == w["sim_time"]
        assert g["wall_s"] > 0 and g["tokens_per_s"] > 0


def test_train_main_own_init_runs_finite(tmp_path):
    log = tmp_path / "log.json"
    recs = train.main(BASE + ["--device", "cpu", "--log", str(log)])
    assert log.exists()
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["drift"])
               for r in recs)


@pytest.mark.parametrize("flag", [
    ["--mesh", "debug"], ["--ckpt", "x"], ["--compression", "topk"],
    ["--het-model", "lognormal"], ["--async-buffer", "2"], ["--controller"],
    ["--objective", "consistency"], ["--personalize", "final_norm"],
    ["--participation", "0.5"],
])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(BASE + ["--device", "cpu"] + flag)


def test_entry_point_without_device_raises_without_cuda(monkeypatch):
    """Default device is cuda; with no card the CLI raises instead of running
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(BASE)
    from repro_torch.utils.device import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    """repro_torch and chip_smoke.py import no jax and nothing of repro."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
