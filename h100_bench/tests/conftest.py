"""Small cells on the CPU: the harness's run with the port's torch engine on
the CPU device (its kernels' plain versions), at sizes a test can hold."""

from __future__ import annotations

import copy

import pytest
import torch

from h100_bench import manifest

MIB = 1 << 20


def small(cell: manifest.Cell, file_bytes: int = 3 * MIB) -> manifest.Cell:
    """``cell`` cut to a test's size: a 3 MiB file (a pool of six up to 2
    MiB); the flat table keeps its 50k rules, which cost nothing to make."""
    c = copy.deepcopy(cell)
    files = c.traffic["files"]
    if files["count"] == 1:
        files["min_bytes"] = files["max_bytes"] = file_bytes
    else:
        files.update(count=6, min_bytes=MIB // 4, max_bytes=2 * MIB)
    c.traffic["warmup_bytes"] = MIB // 4
    return c


@pytest.fixture
def cpu_program(monkeypatch):
    """The port's runner on its torch engine over the CPU device."""
    from blt_tpu_torch.pipeline import engines, runner

    monkeypatch.setattr(runner, "select_engine",
                        lambda *a, **k: engines.TorchEngine(torch.device("cpu"), threads=2))
    return engines.TorchEngine


@pytest.fixture
def cells():
    """Every cell of BENCHMARK.json."""
    man = manifest.load()
    return {w["name"]: manifest.cell(man, w["name"]) for w in man["workloads"]}


@pytest.fixture
def card():
    """The card, decided here and not at import: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
