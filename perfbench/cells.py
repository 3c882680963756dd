"""Everything of one cell, found by name under the benchmark's folder, so
that a configuration, a traffic mix, a cell or a per-layer metric is added
by adding files:

* ``BENCHMARK.json`` (the checkout's root): the metrics, and which cells
  report each;
* ``workloads/<cell>.json``: the cell's configuration and traffic names,
  its ``why``, and the limits of its check;
* ``configs/<config>.json``: the model as it is run;
* ``traffic/<traffic>.json``: the training job (method, M, H, b, S and
  the step's constants);
* ``metrics/<metric>.py``: a per-layer metric's reader.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    job: dict
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list
    folder: str

    def family(self):
        from perfbench import counts
        return counts.family(self.config["family"])

    def reference(self):
        """The reference model's module (``reference/<family>.py``)."""
        return importlib.import_module(
            f"perfbench.reference.{self.config['family']}")

    def spec(self):
        return self.reference().param_spec(self.config)

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = os.path.join(self.folder, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def load(root: str, name: str, folder: str = HERE) -> Cell:
    """Cell ``name`` of the benchmark at checkout ``root``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = _json(os.path.join(folder, "workloads", f"{name}.json"))
    config = _json(os.path.join(folder, "configs", f"{wl['config']}.json"))
    job = _json(os.path.join(folder, "traffic", f"{wl['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, entry["chips"], wl, config, job, e2e, per_layer, folder)
