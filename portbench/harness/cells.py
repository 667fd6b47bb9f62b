"""Cells, configurations, traffic mixes, kernels and per-layer metrics, found by name.

BENCHMARK.json at the checkout's root names each cell's configuration and traffic mix; a
configuration's file is the one its entry names, a traffic mix is traffic/<name>.json, a
per-layer metric's reader is metrics/<name>.py and a kernel's probe kernels/<name>.json.
Nothing here lists a name: a new cell, mix, metric or kernel is a new file (and an entry in
BENCHMARK.json), never an edit of a file that is there."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]  # the configuration file's content
    traffic_name: str
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]  # the e2e metrics this cell reports, setup_s among them
    per_layer: List[Dict[str, Any]]  # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _for_cell(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, root: Path = ROOT, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _for_cell(m, name, e2e_names)]
    return Cell(name, c["name"], config, w["traffic"], traffic, int(w["chips"]), e2e, per_layer)


def reader(metric_name: str, root: Path = ROOT) -> Callable[[Dict[str, Any]], Optional[float]]:
    """The `read(ctx)` function of metrics/<metric_name>.py."""
    path = root / "portbench" / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernels(root: Path = ROOT) -> Dict[str, Dict[str, Any]]:
    """{kernel name: probe description} from kernels/*.json."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((root / "portbench" / "kernels").glob("*.json"))}


def peaks(root: Path = ROOT) -> Dict[str, float]:
    return json.loads((root / "portbench" / "peaks.json").read_text())
