"""What ``BENCHMARK.json`` says of one workload, and the files the harness
finds by the names in it:

- ``configs`` entry ``file``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix, which names its ``entry``;
- ``entries/<entry>.py``: the module that makes the inputs, drives the
  program through the window and judges its outputs;
- ``metrics/<metric>.py``: one reader a per-layer metric;
- ``limits/<workload>.json``: the limit of each number compared.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent  # the checkout
HERE = "jpegbench"  # the harness's directory in it


@dataclass
class Workload:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    root: pathlib.Path
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    def entry(self):
        """The entry module that the traffic mix names."""
        return importlib.import_module(f"jpegbench.entries.{self.traffic['entry']}")


def _applies(metric: dict, workload: str, reported: set) -> bool:
    """A metric with ``workloads`` lists its cells; one without applies to
    every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, to every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(name: str, root: pathlib.Path = ROOT) -> Workload:
    """The workload ``name`` of ``root``'s ``BENCHMARK.json``; raises
    ``KeyError`` for a name it does not hold."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / HERE / "limits" / f"{name}.json").read_text())
    end_to_end = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Workload(name, int(cell["chips"]), config, traffic, limits, root, end_to_end,
                    per_layer)


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = root / HERE / "metrics" / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(
        "jpegbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
