"""BENCHMARK.json and the files it names, each found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
its files are `port_bench/configs/<config>.json` (through the
configuration's `file`), `port_bench/traffic/<traffic>.json`, whose
`generator` names `port_bench/generators/<generator>.py`, and
`port_bench/limits/<cell>.json`, the limits of its correctness check. A
metric, end-to-end or per-layer, is read by `port_bench/metrics/<name>.py`.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

from .env import ROOT

BENCH = ROOT / "port_bench"


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def configuration(bench: Dict, cell: Dict, root: Path = ROOT) -> Dict:
    """The cell's configuration file, as it is run."""
    for cfg in bench["configs"]:
        if cfg["name"] == cell["config"]:
            return json.loads((root / cfg["file"]).read_text())
    raise SystemExit(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> Dict[str, float]:
    return json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())["limits"]


def _applies(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics that list the cell in their `workloads`."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


def load(path: Path) -> ModuleType:
    """A module from its file; names may hold dots."""
    name = "port_bench_" + re.sub(r"\W", "_", str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric(name: str) -> ModuleType:
    return load(BENCH / "metrics" / f"{name}.py")


def generator(name: str) -> ModuleType:
    return load(BENCH / "generators" / f"{name}.py")
