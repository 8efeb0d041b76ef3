"""Finding a cell's parts by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the mix's ``kind`` names its driver
(``drivers/<kind>.py``); the cell's limits sit in ``limits/<cell>.json``;
each per-layer metric is a reader in ``metrics/<name>.py``. Adding a cell,
a mix, a driver or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

__all__ = ["BENCH", "ROOT", "load_benchmark", "Cell"]


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the benchmark with everything its name points to."""

    def __init__(self, benchmark: dict, name: str, bench: Path = BENCH):
        cells = {w["name"]: w for w in benchmark["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in benchmark["configs"]}
        self.config = json.loads((bench.parent / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((bench / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((bench / "limits" / f"{name}.json").read_text())
        self.driver = _module(bench / "drivers" / f"{self.traffic['kind']}.py",
                              f"h100bench_driver_{self.traffic['kind']}")
        self.end_to_end = [m for m in benchmark["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in benchmark["per_layer"] if name in m.get("workloads", [name])]
        self.bench = bench

    def reader(self, metric: dict):
        mod = _module(self.bench / "metrics" / f"{metric['name']}.py",
                      "h100bench_metric_" + metric["name"].replace(".", "_").replace("-", "_"))
        declared = (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES)
        listed = (metric["name"], metric["unit"], metric["layer"], metric["moves"])
        if declared != listed:
            raise ValueError(f"metrics/{metric['name']}.py declares {declared}, "
                             f"BENCHMARK.json {listed}")
        return mod.read
