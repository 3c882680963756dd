"""The reference's local-adam against itself, one ulp apart: how far fp32
rounding alone moves the train_lm bench's loss curve.

Runs ``benchmarks/run.py::_run_train_lm`` for one method (local-adam by
default) twice on the CPU: from the reference's own seed-0 init, and from
that init with every element of every leaf moved one ulp up
(``np.nextafter(x, +inf)``). Everything else (data, keys, step sizes) is
the same, so the two curves part only by the amplified rounding of the
start. Prints both curves and their gap per round, one JSON line each.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_train_lm_ulp_reference.py
  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_train_lm_ulp_reference.py \
      --method savic --rounds 4
"""
import argparse
import json
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmarks.matrix import Point  # noqa: E402
from benchmarks.run import TRAIN_LM_OVERRIDES, _run_train_lm  # noqa: E402
from repro.core import engine  # noqa: E402

FIXED = dict(clients=4, h_local=8, batch=4, seq=64, rounds=10)


def one_ulp_up(params):
    """Every element of every leaf moved to the next fp32 value up."""
    return jax.tree.map(
        lambda x: np.nextafter(np.asarray(x), np.float32(np.inf)).astype(
            np.asarray(x).dtype), jax.device_get(params))


def run(method, rounds, moved):
    """The bench row's loss curve; ``moved`` starts one ulp up."""
    real = engine.init_state

    def init_state(key, init_params_fn, spec, n_clients):
        fn = (lambda k: one_ulp_up(init_params_fn(k))) if moved \
            else init_params_fn
        return real(key, fn, spec, n_clients)

    engine.init_state = init_state
    try:
        row, = _run_train_lm(Point({"method": method},
                                   dict(FIXED, rounds=rounds), 0), {})
    finally:
        engine.init_state = real
    return row["info"]["loss_curve"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="local-adam",
                    choices=list(TRAIN_LM_OVERRIDES))
    ap.add_argument("--rounds", type=int, default=FIXED["rounds"])
    args = ap.parse_args()
    base = run(args.method, args.rounds, moved=False)
    moved = run(args.method, args.rounds, moved=True)
    print(json.dumps({"method": args.method, "seed0": base,
                      "one_ulp_up": moved,
                      "gap": [round(abs(a - b), 4) for a, b in
                              zip(base, moved)]}), flush=True)


if __name__ == "__main__":
    main()
