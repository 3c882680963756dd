"""The port's train_lm runner beside the reference's, from the reference's
seed-0 weights, on the CPU: each method's per-round loss curve from
``benchmarks/run.py::_run_train_lm`` and from
``repro_torch.launch.train_lm.run_method``, one line each, at the bench's
fixed point (10 rounds unless ``--rounds``).

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_train_lm_vs_reference.py
  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_train_lm_vs_reference.py \
      --methods local-adam --rounds 4
"""
import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmarks.matrix import Point  # noqa: E402
from benchmarks.run import _run_train_lm  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import ModelCallConfig, build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", default=",".join(train_lm.TRAIN_LM_OVERRIDES))
    ap.add_argument("--rounds", type=int, default=train_lm.FIXED["rounds"])
    args = ap.parse_args()
    init = jax.device_get(build(get_config("qwen2-0.5b", reduced=True),
                                ModelCallConfig(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    fixed = dict(train_lm.FIXED, rounds=args.rounds)
    for m in args.methods.split(","):
        want, = _run_train_lm(Point({"method": m}, fixed, 0), {})
        got = train_lm.run_method(
            m, device="cpu", rounds=args.rounds,
            init_params=lambda g: params_from_jax(init, g.device))
        print(json.dumps({"method": m,
                          "reference": want["info"]["loss_curve"],
                          "port": got["info"]["loss_curve"]}), flush=True)


if __name__ == "__main__":
    main()
