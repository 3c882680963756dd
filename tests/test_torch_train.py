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
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_rng_replay import JaxStream
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


INT8_EF = ["--compression", "int8-stochastic", "--error-feedback"]
OASIS_PART = ["--preconditioner", "oasis", "--participation", "0.5"]
TOPK_EF = ["--compression", "topk", "--compression-k", "0.2",
           "--error-feedback"]
# H_m = (2, 4) at --het-seed 2 for two clients
HET_ASYNC = ["--h-local", "4", "--het-model", "lognormal", "--het-seed", "2",
             "--async-buffer", "2", "--staleness-weight", "polynomial"]
# a gate the random init's near-uniform predictions open
SEMI_PERSONAL = ["--objective", "pseudo-label", "--labeled-frac", "0.5",
                 "--pseudo-threshold", "1e-4", "--personalize", "final_norm"]
CONTROLLER = ["--h-local", "4", "--controller", "--async-buffer", "2",
              "--het-model", "lognormal", "--het-seed", "2",
              "--compression", "topk", "--compression-k", "0.1",
              "--error-feedback", "--ctrl-noise-target", "1e-3"]


@pytest.mark.parametrize("method,flags,fused", [
    ("savic", [], True), ("local-adam", [], True), ("fedadam", [], False),
    ("savic", INT8_EF, True), ("savic", OASIS_PART, True),
    ("local-adam", TOPK_EF, False),
    ("savic", HET_ASYNC, True), ("fedadam", HET_ASYNC, False),
    ("local-adam", SEMI_PERSONAL, True), ("fedavg", SEMI_PERSONAL, False),
    ("savic", CONTROLLER, True),
], ids=["savic-fused", "local-adam-fused", "fedadam-tree",
        "savic-int8-ef-fused", "savic-oasis-part-fused",
        "local-adam-topk-ef-tree", "savic-het-async-fused",
        "fedadam-het-async-tree", "local-adam-semi-personal-fused",
        "fedavg-semi-personal-tree", "savic-controller-fused"])
def test_train_main_matches_reference(method, flags, fused):
    """The reference runs its tree path (its own tests pin its fused path
    bitwise to it, and the tree path skips the Pallas interpreter). Its
    round keys ``fold_in(PRNGKey(seed + 1), r)`` are replayed into the port
    through ``JaxStream``; ``compression_err`` holds at 1e-3 relative (XLA's
    CPU ``vdot`` sums in fp32 sequentially), and so does the controller's
    gradient-noise EMA (the reference's noise inputs are ``vdot`` sums);
    staleness 1e-5; H_m, H_t, b_eff, k and the simulated times exactly."""
    extra = ["--method", method] + flags
    want = jtrain.main(BASE + extra)
    got = train.main(BASE + extra + ["--device", "cpu"]
                     + (["--use-fused-kernel"] if fused else []),
                     init_params=_reference_init(),
                     root_stream=JaxStream(jax.random.PRNGKey(1)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["drift"], w["drift"], rtol=1e-4)
        assert ("step_norm" in g) == ("step_norm" in w)
        if "step_norm" in w:
            np.testing.assert_allclose(g["step_norm"], w["step_norm"],
                                       rtol=1e-3)
        assert ("compression_err" in g) == ("compression_err" in w)
        if "compression_err" in w:
            np.testing.assert_allclose(g["compression_err"],
                                       w["compression_err"], rtol=1e-3)
        for k in ("sim_time", "sim_round_time", "ctrl_h_m", "ctrl_h_t",
                  "ctrl_k", "ctrl_b_eff"):
            assert (k in g) == (k in w), k
            assert g.get(k) == w.get(k), k
        for k, rtol in (("staleness", 1e-5), ("ctrl_gns_ema", 1e-3)):
            assert (k in g) == (k in w), k
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6)
        assert g["wall_s"] > 0 and g["tokens_per_s"] > 0


def test_train_records_the_wire_payload():
    """Each round records bytes_on_wire's delta_bytes and compression_x;
    compressed rounds also the measured per-client payload and the
    compression error, and the two payloads agree."""
    recs = train.main(BASE + ["--device", "cpu", "--compression",
                              "int8-stochastic", "--error-feedback",
                              "--use-fused-kernel"])
    for rec in recs:
        assert rec["wire_bytes"] == [rec["delta_bytes"]] * 2
        assert rec["compression_x"] > 1.0
        assert np.isfinite(rec["compression_err"])
        assert rec["compression_err"] > 0.0
    plain = train.main(BASE + ["--device", "cpu"])
    assert plain[0]["compression_x"] == 1.0
    assert "compression_err" not in plain[0]


def test_train_rounds_are_addressed_by_seed_and_round():
    """The production stream derives round r's draws from (seed, r) only:
    a second run replays the first, and another seed draws otherwise."""
    argv = BASE + ["--device", "cpu", "--participation", "0.5",
                   "--compression", "randk", "--compression-k", "0.3"]
    a, b = train.main(argv), train.main(argv)
    c = train.main(argv + ["--seed", "1"])
    key = lambda recs: [(r["loss"], r["compression_err"]) for r in recs]
    assert key(a) == key(b)
    assert key(a) != key(c)


def test_first_round_leaves_no_tensor_in_a_reference_cycle():
    """With the cyclic GC off, one reduced round of train.main leaves no
    tensor that only the cyclic GC could free (the first
    torch.utils.checkpoint call used to import torch._dynamo under the
    round's frames and tie them into a cycle)."""
    code = (
        "import gc, sys\n"
        "gc.disable()\n"
        "import torch\n"
        "from repro_torch.launch import train\n"
        "train.main(sys.argv[1:])\n"
        "gc.set_debug(gc.DEBUG_SAVEALL)\n"
        "gc.collect()\n"
        "n = sum(isinstance(o, torch.Tensor) for o in gc.garbage)\n"
        "print('TENSORS_IN_CYCLES', n)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "qwen2-0.5b", "--reduced",
         "--rounds", "1", "--h-local", "1", "--clients", "1", "--batch", "1",
         "--seq", "8", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "TENSORS_IN_CYCLES 0" in out.stdout, out.stdout


def test_train_main_own_init_runs_finite(tmp_path):
    log = tmp_path / "log.json"
    recs = train.main(BASE + ["--device", "cpu", "--log", str(log)])
    assert log.exists()
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["drift"])
               for r in recs)


@pytest.mark.parametrize("flag", [
    ["--mesh", "debug"], ["--ckpt", "x"],
    ["--het-model", "lognormal"], ["--async-buffer", "2"], ["--controller"],
    ["--objective", "consistency"], ["--personalize", "final_norm"],
])
def test_unported_flags_raise(flag):
    """Only --mesh and --ckpt are outside the port, and raise; every other
    flag the port once refused is no longer listed."""
    argv = BASE + ["--device", "cpu"] + flag
    listed = train._unported_flags(train._parser().parse_args(argv))
    if flag[0] in ("--mesh", "--ckpt"):
        assert listed == [flag[0]]
        with pytest.raises(NotImplementedError, match="not ported"):
            train.main(argv)
    else:
        assert listed == []


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


def test_port_sources_name_no_jax_or_reference_module():
    """A text search of repro_torch and chip_smoke.py: no line imports jax,
    jaxlib or repro, statically or through importlib / __import__ (which
    the AST check above does not see)."""
    import re
    pat = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)"
        r"|(?:import_module|__import__)\(\s*[\"'](?:jax|jaxlib|repro)[.\"']")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = [(p, i, line) for p in files
            for i, line in enumerate(open(p).read().splitlines(), 1)
            if pat.search(line)]
    assert not hits, hits
