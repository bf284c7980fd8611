"""A cell of ``BENCHMARK.json`` and the data files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` and the readers
``metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration,
    its traffic and the metrics it reports."""
    spec = json.loads(benchmark.read_text())
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    cfg = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(name=name, chips=int(work["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def _frozen(value):
    """JSON lists as tuples, so a frozen config hashes (the models cache
    tables keyed by their config)."""
    if isinstance(value, list):
        return tuple(_frozen(v) for v in value)
    return value


def build_config(cls, data: Dict[str, Any]):
    """The dataclass ``cls`` with every field the file gives, nested
    dataclasses built the same way; a key the class lacks raises."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    kwargs = {}
    for key, value in data.items():
        f = fields[key]
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        if dataclasses.is_dataclass(default):
            kwargs[key] = build_config(type(default), value)
        else:
            kwargs[key] = _frozen(value)
    return cls(**kwargs)
