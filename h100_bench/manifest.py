"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is the
entry's ``file``, and a traffic mix, ``traffic/<name>.json``; each metric is
``metrics/<name>.py``, whose ``read(window)`` returns the number or None;
each table recipe is ``tables/<recipe>.py``. Adding any of them is adding a
file and an entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(root / config["file"]) as f:
        config_file = json.load(f)
    with open(root / HERE.name / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layers = [m for m in manifest["per_layer"]
              if _applies(m, name) and m["moves"] in reported]
    return Cell(name, entry["chips"], config_file, traffic, e2e, layers)


def _module(kind: str, name: str, root: Path):
    path = root / HERE.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: Path = ROOT):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    return _module("metrics", name, root)


def recipe(name: str, root: Path = ROOT):
    """The table recipe ``name``: ``tables/<name>.py``."""
    return _module("tables", name, root)


def read_metrics(entries: List[dict], window, root: Path = ROOT) -> dict:
    """Each metric's number with its unit; a reader that finds nothing to
    read returns None, and its metric is left out."""
    out = {}
    for m in entries:
        value: Optional[float] = metric(m["name"], root).read(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
