"""A cell of ``BENCHMARK.json`` and the files it names, found by name:

- ``configs/<file>``: the configuration as it is run; its ``family`` names
  ``families/<family>.py`` (the program's entry points and the reference);
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``;
- ``limits/<cell>.json``: the limit of each number that decides ``correct``;
- ``metrics/<metric>.py``: the reader of each per-layer metric the cell
  reports.

``held.json`` keeps, in ``BENCHMARK.json``'s form, the entries of cells taken
out of the benchmark whose files stay: the CPU tests and ``control.py`` load
them with ``held=True``; ``run.py`` never does.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    cell: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    # a precision: the plain reference in it takes the program's place (the
    # control, ``control.py``); None in every benchmark run
    control: Optional[str] = None

    @property
    def family(self) -> ModuleType:
        return importlib.import_module(f"cardbench.families.{self.config['family']}")

    @property
    def driver(self) -> ModuleType:
        return importlib.import_module(f"cardbench.drivers.{self.traffic['driver']}")


def benchmark(root: str = ROOT, held: bool = False) -> Dict:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    if held:
        more = _json(os.path.join(root, "cardbench", "held.json"))
        bench = {k: v + more.get(k, []) if isinstance(v, list) else v for k, v in bench.items()}
    return bench


def metrics_of(bench: Dict, cell: str):
    """The cell's end-to-end metrics and the per-layer metrics it reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def load(cell_name: str, root: str = ROOT, held: bool = False) -> Spec:
    """The cell of ``BENCHMARK.json`` by that name (``held``: or of
    ``held.json``)."""
    bench = benchmark(root, held)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[cell_name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e, per_layer = metrics_of(bench, cell_name)
    return Spec(
        cell=cell,
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(root, "cardbench", "traffic", f"{cell['traffic']}.json")),
        limits=_json(os.path.join(root, "cardbench", "limits", f"{cell_name}.json"))["limits"],
        end_to_end=e2e,
        per_layer=per_layer,
    )


def reader(metric: str, root: str = ROOT) -> ModuleType:
    """``metrics/<metric>.py``, loaded by its path (a name may hold dots)."""
    path = os.path.join(root, "cardbench", "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
