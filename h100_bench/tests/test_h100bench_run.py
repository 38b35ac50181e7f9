"""A whole run on the CPU at a test's size: the result's line, the faults
that have to make ``correct`` false, the control, the exits without a card
or a program, and the import scan."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from h100_bench import manifest, run
from h100_bench.tests.conftest import small

CPU = torch.device("cpu")
CELLS = ["flat50k.text"]


def _bytes(out) -> np.ndarray:
    return np.ascontiguousarray(out).reshape(-1).view(np.uint8)


def _unchanged(real, self, chunks, table, hint):
    """A step that returns its state unchanged: every byte its own token."""
    for chunk in chunks:
        yield np.asarray(chunk).astype(">u2")


def _half_left_out(real, self, chunks, table, hint):
    """Half of each batch's output left out."""
    for out in real(self, chunks, table, hint):
        b = _bytes(out)
        yield b[: (b.shape[0] // 4) * 2]


def _token_altered(real, self, chunks, table, hint):
    """One token altered where it is produced: the first of the first batch."""
    for i, out in enumerate(real(self, chunks, table, hint)):
        b = _bytes(out).copy()
        if i == 0 and b.shape[0] >= 2:
            b[1] ^= 1
        yield b


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_its_line_keeps_the_format(name, cells, cpu_program):
    result, notes = run.run(small(cells[name]), 2**31 + 11, 0.3, False, CPU)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"tokenize_MBps", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["checks"] == {"jobs_wrong": {"value": 0, "limit": 0},
                                "tokens_wrong": {"value": 0, "limit": 0}}
    assert json.loads(json.dumps(result)) == result
    assert any(n.startswith("job seconds in order") for n in notes)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_per_layer_metrics(name, cells, cpu_program):
    result, _ = run.run(small(cells[name]), 5, 0.3, True, CPU)
    assert list(result)[-2:] == ["breakdown", "checks"] and result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["metrics"]) <= {m["name"] for m in cells[name].per_layer}
    assert {"drain_busy_share", "feed_busy_share"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _token_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(fault, name, cells, cpu_program, monkeypatch):
    real = cpu_program.bpe_stream
    monkeypatch.setattr(cpu_program, "bpe_stream",
                        lambda self, chunks, table, hint: fault(real, self, chunks, table, hint))
    result, _ = run.run(small(cells[name]), 3, 0.3, False, CPU)
    assert not result["correct"]
    assert result["checks"]["jobs_wrong"]["value"] == result["attempted"] == result["failed"]
    assert result["checks"]["tokens_wrong"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, cells):
    """The control at a test's size: the table keeps its 50k rules, so the
    control's 8192 differ from it."""
    result, _ = run.run(small(cells[name]), 4, 0.3, False, CPU, control=True)
    assert not result["correct"] and result["checks"]["tokens_wrong"]["value"] > 0


def _patch_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


ARGS = ["--workload", "flat50k.text", "--seed", "1", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_no_program_no_result(capsys, monkeypatch):
    _patch_card(monkeypatch)
    monkeypatch.setitem(sys.modules, "blt_tpu_torch", None)
    assert run.main(ARGS) == 1
    out = capsys.readouterr()
    assert out.out == "" and "not importable" in out.err


def test_jax_in_the_process_no_result(capsys, monkeypatch):
    _patch_card(monkeypatch)
    monkeypatch.setattr(run, "run", lambda *a, **k: ({"checks": {}}, []))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(ARGS) == 1
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "blt_tpu_torch_extra", types.ModuleType("blt_tpu_torch_extra"))
    assert run.main(ARGS) == 0  # a name that begins with a forbidden one is not it


def test_the_last_lines(capsys, monkeypatch, cells, cpu_program):
    _patch_card(monkeypatch)
    cell = small(cells["flat50k.text"])
    real = run.run
    monkeypatch.setattr(run, "run", lambda c, seed, seconds, traced, device, control=False:
                        real(cell, seed, seconds, traced, CPU, control))
    assert run.main(ARGS) == 0
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks" and last["correct"]
    assert out.err.strip().splitlines()[-2:] == ["check jobs_wrong 0 limit 0",
                                                 "check tokens_wrong 0 limit 0"]


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(manifest.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "h100_bench.run", *ARGS], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_imports():
    """Top-level names compared whole: ``blt_tpu_torch`` is not ``blt_tpu``."""
    files = sorted(manifest.HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        names = set(_imports(f))
        assert not names & set(run.FORBIDDEN), f
        if f.parent.name in ("reference", "common", "tables", "metrics"):
            assert "blt_tpu_torch" not in names, f


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card(name, cells, card):
    """A short run of each cell on the card, then its control."""
    result, _ = run.run(cells[name], 77, 1.0, False, card)
    assert result["correct"] and result["device"]["platform"] == "gpu"
    result, _ = run.run(cells[name], 78, 1.0, False, card, control=True)
    assert not result["correct"]


@pytest.mark.parametrize("threads", [None, 3])
def test_the_configuration_sets_the_entry(threads, monkeypatch):
    """A configuration's ``threads`` and ``chunk_size`` reach the CLI's flags,
    and are left to the program where the file has none."""
    from h100_bench.tables import Table

    program = run.Program()
    seen = []
    monkeypatch.setattr(program.cli, "main", lambda argv: seen.append(argv) or 0)
    config = {"chunk_size": "4MB", "threads": threads}
    job = program.entry({"entry": "cli", "content_type": "text"}, config,
                        Table({(97, 98): 256}, [(97, 98)]))
    try:
        job("in", "out")
    finally:
        program.close()
    argv = seen[0]
    assert argv[:4] == ["-i", "in", "-o", "out"] and "--chunksize" in argv
    assert ("--threads" in argv) == (threads is not None)
    if threads is not None:
        assert argv[argv.index("--threads") + 1] == "3"
