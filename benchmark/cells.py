"""Resolve a cell of ``BENCHMARK.json`` from its files, by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything that belongs to one of them sits in a file of its own:

- ``benchmark/configs/<config>.json``: the configuration (the file that
  ``configs[].file`` names);
- ``benchmark/traffic/<traffic>.json``: the mix, read by the one
  generator in ``traffic.py``;
- ``benchmark/checks/<cell>.json``: the limit of each number that the
  comparison with the plain reference decides ``correct`` by;
- ``benchmark/metrics/<metric>.py``: one reader for each per-layer
  metric;
- ``benchmark/functions/<function>.py``: the function a configuration
  interpolates;
- ``benchmark/representations/<kind>.py``: how the program builds a
  configuration's ``representation.kind`` through the port, its work
  counts, and its plain reference;
- ``benchmark/engines/<engine>.py``: how the program makes the serving
  engine a traffic mix names;
- ``benchmark/tiers/<dtype>.json``: a precision tier (a mix's
  ``dtype``): the engine's dtype argument, the points' dtype, the key of
  its peak in ``peaks.json`` and its bytes an item;
- ``benchmark/kernels/<fragment>.json``: a hand-written kernel of the
  port whose launches a trace is checked for: the fragment of its
  device operations' names, and the port's counters of its launches;
- ``benchmark/counters/<name>.json``: a counter of the port
  (``<module>:<attribute>`` under the port) whose change over the traced
  requests the record carries under ``name`` for the readers.

So a later cell, mix, metric, function, representation, engine, tier,
counted kernel or counter is new files and entries, and no edit of a
file that is here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]] = None
    reader: Optional[Callable] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: Dict[str, float]
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def function(name: str) -> Callable:
    """``values(points)`` of ``benchmark/functions/<name>.py``."""
    return importlib.import_module(f"benchmark.functions.{name}").values


def _module(folder: str, name: str):
    """``benchmark/<folder>/<name>.py``, loaded from its path (a name may
    hold a dot, or begin with a capital)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(ROOT).as_posix()}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> Callable:
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    return _module("metrics", metric).read


def representation(config: dict):
    """``benchmark/representations/<kind>.py`` of ``config``'s
    representation: ``build``, ``work_counts`` and ``reference``."""
    return _module("representations", config["representation"]["kind"])


def engine(traffic: dict):
    """``benchmark/engines/<engine>.py`` of ``traffic``: ``make``."""
    return _module("engines", traffic["engine"])


def tier(traffic: dict) -> dict:
    """``benchmark/tiers/<dtype>.json`` of ``traffic``."""
    return load_json(HERE / "tiers" / f"{traffic['dtype']}.json")


def counted_kernels() -> List[dict]:
    """Every ``benchmark/kernels/<fragment>.json``, with its
    ``fragment``."""
    return [dict(load_json(path), fragment=path.stem)
            for path in sorted((HERE / "kernels").glob("*.json"))]


def counters() -> Dict[str, str]:
    """Every ``benchmark/counters/<name>.json``: its ``counter`` by
    ``name``."""
    return {path.stem: load_json(path)["counter"]
            for path in sorted((HERE / "counters").glob("*.json"))}


def _metrics(entries, cell: str, readers: bool) -> List[Metric]:
    out = []
    for e in entries:
        m = Metric(name=e["name"], unit=e["unit"],
                   workloads=e.get("workloads"))
        if not m.applies_to(cell):
            continue
        if readers:
            m.reader = reader(m.name)
        out.append(m)
    return out


def resolve(workload: str, bench: Optional[dict] = None) -> Cell:
    """The cell named ``workload`` with its configuration, mix, limits
    and metrics.  Raises ``KeyError`` for a name ``BENCHMARK.json`` does
    not have."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    checks = load_json(HERE / "checks" / f"{workload}.json")
    limits = {name: float(c["limit"]) for name, c in checks["numbers"].items()}
    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=traffic, checks=limits,
                end_to_end=_metrics(bench["end_to_end"], workload, False),
                per_layer=_metrics(bench["per_layer"], workload, True))
