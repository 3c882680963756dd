"""End-to-end driver on the PyTorch port: train a ~100M-parameter
qwen2-family LM (the port's counterpart of ``examples/train_lm.py``).

  PYTHONPATH=src python examples/train_lm_torch.py               # full, cuda
  PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu \
      --method local-adam

Thin wrapper over ``repro_torch.launch.train``: registers the same custom
config as ``examples/train_lm.py`` (``lm-100m``, and its ``--tiny``
reduction) through ``repro_torch.configs.register``, picks the same
size-appropriate defaults, runs the fused client loop (one fused-step
kernel launch per local step), and forwards every other flag to the driver
verbatim (``--compression``, ``--controller``, ...).

Restart is deterministic: rerunning with the same ``--ckpt`` resumes at the
saved round and replays the same per-round streams and round-addressable
data, bitwise. ``--ckpt`` and ``--log`` default to the temporary directory
(``TMPDIR``), outside the repository.
"""
import argparse
import os
import sys
import tempfile
import types

from repro_torch.configs import ModelConfig, register
from repro_torch.launch import train as train_mod

ap = argparse.ArgumentParser()
ap.add_argument("--tiny", action="store_true")
ap.add_argument("--rounds", type=int, default=0)
ap.add_argument("--method", default="savic",
                help="engine method (savic | fedavg | fedadagrad | fedadam "
                     "| fedyogi | local-adam)")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                               "repro_torch_lm_ckpt"))
ap.add_argument("--log", default=os.path.join(tempfile.gettempdir(),
                                              "repro_torch_train_lm_log.json"))
args, passthrough = ap.parse_known_args()

# the custom ~100M arch of examples/train_lm.py, registered with the port
CONFIG = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=3072, vocab_size=8192, qkv_bias=True,
    tie_embeddings=True, source="examples/train_lm.py",
)
REDUCED = CONFIG.replace(name="lm-100m-tiny", n_layers=2, d_model=128,
                         n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512)
mod = types.ModuleType("repro_torch.configs.lm_100m")
mod.CONFIG, mod.REDUCED = CONFIG, REDUCED
sys.modules["repro_torch.configs.lm_100m"] = mod
register("lm-100m", "lm_100m")

print(f"params (full): {CONFIG.param_count()/1e6:.0f}M")

rounds = args.rounds or (5 if args.tiny else 300)
train_args = ["--arch", "lm-100m", "--rounds", str(rounds),
              "--method", args.method, "--device", args.device,
              "--use-fused-kernel",
              "--h-local", "4", "--clients", "4",
              "--batch", "4" if args.tiny else "8",
              "--seq", "64" if args.tiny else "256",
              "--preconditioner", "adam", "--gamma", "3e-3",
              "--ckpt", args.ckpt, "--ckpt-every", "25",
              "--log", args.log]
if args.tiny:
    train_args.append("--reduced")
log = train_mod.main(train_args + passthrough)
if log:
    print(f"final loss {log[-1]['loss']:.4f} (round {log[-1]['round']})")
else:
    print(f"nothing to run: {args.ckpt} already holds round {rounds}")
