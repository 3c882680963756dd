"""Shared by ``tests/test_torch_train_families_*.py``: ``train.main`` of the
port against ``repro.launch.train.main`` of the reference for one family
on its reduced config, from the reference's initial weights (passed through
``repro_torch.bridge``) with its round keys replayed (``JaxStream``), as
``tests/test_torch_train.py`` does for qwen2-0.5b."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_rng_replay import JaxStream
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro_torch.bridge import params_from_jax
from repro_torch.launch import train

# 2 rounds, M 2, H 2, b 1 (--seq per case)
BASE = ["--reduced", "--rounds", "2", "--h-local", "2", "--clients", "2",
        "--batch", "1"]


def reference_init(arch, seed=0):
    """The reference's fp32 initial weights of reduced ``arch``, as an
    ``init_params`` for the port's ``train.main``."""
    cfg = jget_config(arch, reduced=True)
    params = jbuild(cfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(seed))
    np_params = jax.device_get(params)
    return lambda gen: params_from_jax(np_params, gen.device)


def run_both(arch, seq, extra=(), fused=False):
    """(port's records, reference's records) of the same run. The
    reference runs its tree loop (its own tests pin its fused loop to it);
    ``fused`` puts the port on its fused loop."""
    argv = ["--arch", arch, "--seq", str(seq)] + BASE + list(extra)
    want = jtrain.main(argv)
    got = train.main(argv + ["--device", "cpu"]
                     + (["--use-fused-kernel"] if fused else []),
                     init_params=reference_init(arch),
                     root_stream=JaxStream(jax.random.PRNGKey(1)))
    return got, want


def hold(got, want, loss_rtol=1e-5, drift_rtol=1e-4, step_rtol=1e-3):
    """Loss, drift and the adaptive server's step norm round by round, at
    the given relative tolerances (``tests/test_torch_train.py``'s for
    fp32); every record finite."""
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert all(np.isfinite(v) for v in g.values()
                   if isinstance(v, float))
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(g["drift"], w["drift"], rtol=drift_rtol)
        assert ("step_norm" in g) == ("step_norm" in w)
        if "step_norm" in w:
            np.testing.assert_allclose(g["step_norm"], w["step_norm"],
                                       rtol=step_rtol)
        assert g["sim_time"] == w["sim_time"]


torch.set_num_threads(1)
