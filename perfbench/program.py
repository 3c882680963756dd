"""The system under test: the port's training entry, driven as a user
drives it. ``train.setup(argv, init_params=...)`` builds the round
(``core/engine.build_round_step`` over ``model.loss`` on the fused K1
loop) and its state from the benchmark's weights; each round's batch comes
from ``train.round_batch``. The benchmark takes from the program nothing
but that, the state it judges, and its kernels' names.

A configuration cut in depth, or run at its published RoPE base where the
program's config has another, is registered as the program lets a caller
register one (``configs.register``), under an id of its own; no file of
the program is edited.
"""
from __future__ import annotations

import sys
import types

from perfbench.reference import measures, weights

# the program's config fields that the configuration file states
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "qkv_bias", "tie_embeddings", "act", "norm_eps",
          "rope_theta")
# those the benchmark sets on the program's config, each with the id's suffix
SET = {"n_layers": "{:d}l", "rope_theta": "rope{:.0f}"}


def arch_id(config) -> str:
    """The program's id of ``config``: its arch, or the arch with the
    ``SET`` fields the file gives otherwise (the depth, the RoPE base)
    registered under ``<arch>-<suffix>...``, e.g. ``mamba2-1.3b-24l``;
    raises where the program's config differs from the file in another
    field the file states."""
    from repro_torch import configs
    arch = config["arch"]
    cfg = configs.get_config(arch)
    new = {k: config[k] for k in SET
           if k in config and getattr(cfg, k) != config[k]}
    name = "-".join([arch] + [SET[k].format(v) for k, v in new.items()])
    if new:
        mod = types.ModuleType("repro_torch.configs.perfbench_"
                               + name.replace("-", "_").replace(".", "p"))
        mod.CONFIG = mod.REDUCED = cfg.replace(**new)
        sys.modules[mod.__name__] = mod
        configs.register(name, mod.__name__.rsplit(".", 1)[1])
        cfg = configs.get_config(name)
    wrong = [f"{k}: program {getattr(cfg, k)!r}, file {config[k]!r}"
             for k in FIELDS if k in config and getattr(cfg, k) != config[k]]
    if "ssm" in config:
        wrong += [f"ssm.{k}: program {getattr(cfg.ssm, k)!r}, file {v!r}"
                  for k, v in config["ssm"].items()
                  if getattr(cfg.ssm, k) != v]
    if wrong:
        raise ValueError(f"the program's {name} is not the configuration "
                         f"file's: " + "; ".join(wrong))
    return name


def argv(cell, seed: int, device: str) -> list:
    job, config = cell.job, cell.config
    out = ["--arch", arch_id(config), "--device", device, "--seed", str(seed),
           "--dtype", config["dtype"], "--method", job["method"],
           "--preconditioner", job["preconditioner"],
           "--scaling", job["scaling"], "--clients", str(job["clients"]),
           "--h-local", str(job["h_local"]), "--batch", str(job["batch"]),
           "--seq", str(job["seq"]), "--gamma", repr(job["gamma"]),
           "--beta1", repr(job["beta1"]), "--alpha", repr(job["alpha"])]
    return out + (["--use-fused-kernel"] if job["fused_kernel"] else [])


class Program:
    """One training run of the program: its state and its rounds."""

    def __init__(self, cell, seed: int, device: str):
        from repro_torch.launch import train
        self._train = train
        self.cell, self.seed = cell, seed
        spec = cell.spec()
        init = lambda gen: weights.make(spec, seed, gen.device)
        self.run = train.setup(argv(cell, seed, device), init_params=init)
        pc, cl = self.run.spec.precond, self.run.spec.client
        job = cell.job
        if (pc.beta2, cl.lr, cl.momentum, pc.alpha) != (
                job["beta2"], job["gamma"], job["beta1"], job["alpha"]):
            raise ValueError("the program's round is not the traffic file's "
                             "(beta2, gamma, beta1, alpha)")
        self.state, self.run.state = self.run.state, None
        self.device = self.run.device

    def batch(self, r: int):
        return self._train.round_batch(self.run.loader, self.run.args, r,
                                       self.device)

    def step(self, batch, r: int):
        """Round ``r`` on ``batch``; returns its loss (a device tensor)."""
        self.state, met = self.run.round_step(self.state, batch,
                                              self.run.stream(r))
        return met["loss"]

    def first_rounds(self, n: int) -> dict:
        """Rounds 0 … n-1, as the window runs them, and what the check
        compares of them: each loss, the momentum's and the D statistic's
        norms after the first, the params' change after the last."""
        job = self.cell.job
        out = {"losses": []}
        for r in range(n):
            out["losses"].append(float(self.step(self.batch(r), r)))
            if r == 0:
                out["mom"] = {k: measures.sumsq64(v[0]) ** 0.5
                              for k, v in weights.paths(self.state["mom"])}
                local = job["scaling"] == "local"
                out["dstat"] = {
                    k: measures.dstat_norm_rows(
                        list(v.unbind(0)) if local else [v], job)
                    for k, v in weights.paths(self.state["precond"]["d"])}
        x0 = dict(weights.paths(weights.make(self.cell.spec(), self.seed,
                                             self.device)))
        out["change"] = {k: measures.sumsq64(v[0] - x0[k]) ** 0.5
                         for k, v in weights.paths(self.state["params"])}
        return out

    def free(self):
        self.state = None
        self.run = None
