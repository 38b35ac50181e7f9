"""``BENCHMARK.json`` against the format its readers expect, discovery by name, and
a throwaway cell added as files alone in a copy of the harness."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from h100_bench import manifest, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100_bench"]
    assert bench["command"] == ["python3", "-m", "h100_bench.run"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_full_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in bench[kind]}) == len(bench[kind])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/") and Path(manifest.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m.get("workloads", cells)) <= cells and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_resolves_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert (manifest.HERE / "tables" / f"{cell.config['table']['recipe']}.py").is_file()
        assert cell.traffic["entry"] in ("api", "cli")
    with pytest.raises(KeyError):
        manifest.cell(bench, "no.such.cell")


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_files_and_entries_alone(tmp_path, bench, cpu_program):
    """A configuration, a traffic mix, a table recipe and a per-layer metric
    added in a copy of the harness as new files and new entries: no file
    that was there changes, and a run finds and uses them all."""
    root = tmp_path
    shutil.copytree(manifest.HERE, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root / "h100_bench")
    (root / "h100_bench/configs/tiny.json").write_text(json.dumps(
        {"name": "tiny", "table": {"recipe": "first_pairs", "k": 40}, "chunk_size": None}))
    (root / "h100_bench/traffic/tiny.api.json").write_text(json.dumps(
        {"entry": "api", "content": "text", "content_type": "text",
         "files": {"count": 3, "min_bytes": 1 << 16, "max_bytes": 1 << 18}, "warmup_bytes": 1 << 14}))
    (root / "h100_bench/tables/first_pairs.py").write_text(
        "from h100_bench.common import recipes\nfrom h100_bench.tables import Table\n\n\n"
        "def build(params, seed, device):\n"
        "    pairs = recipes.frequent_pairs(recipes.text_sample(seed), params['k'])\n"
        "    return Table(recipes.numbered(pairs), pairs)\n")
    (root / "h100_bench/metrics/jobs_done.py").write_text(
        "def read(w):\n    return float(len(w.jobs))\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "tiny", "source": "a test", "file": "h100_bench/configs/tiny.json",
                           "reduced": [], "why": "a test"})
    new["workloads"].append({"name": "tiny.api", "config": "tiny", "traffic": "tiny.api",
                             "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                             "source": "host_clock", "layer": "entry", "moves": "tokenize_MBps",
                             "workloads": ["tiny.api"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = manifest.cell(manifest.load(root), "tiny.api", root)
    assert [m["name"] for m in cell.per_layer] == ["jobs_done"]
    result, _ = run.run(cell, 7, 0.2, True, torch.device("cpu"), root=root)
    assert result["correct"] and result["metrics"]["jobs_done"]["value"] == result["attempted"]
    after = _digest(root / "h100_bench")
    assert {k: v for k, v in after.items() if k in before} == before
