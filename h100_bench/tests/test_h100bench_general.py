"""The general-table configuration: the learned table recipe, the two
readers of the multipass loop's spans, and a run of its cell on the CPU at
a test's size (a smaller sample, so fewer rules, and 256 KiB chunks)."""

from __future__ import annotations

import sys
import types
from collections import namedtuple

import pytest
import torch

from h100_bench import manifest, run
from h100_bench.common.window import Job, Window
from h100_bench.reference import bpe
from h100_bench.tables import learned
from h100_bench.tests.conftest import small

CPU = torch.device("cpu")
CELL = "general50k.text"
READERS = {"mp_loop_share": "mp.chunk", "mp_read_wait_share": "mp.read"}
SMALL = {"rules": 9000, "per_round": 500, "sample_bytes": 256 << 10}
S = namedtuple("S", "id name job batch parent thread start_ns end_ns")
SEC = 1_000_000_000


def test_the_configured_table(cells):
    """The configuration's own table: 50,000 rules valued 256..50255, each
    once, some on merged tokens (a general table)."""
    spec = cells[CELL].config["table"]
    table = manifest.recipe(spec["recipe"]).build(spec, 2**31 + 5, CPU)
    assert len(table.rules) == spec["rules"] == 50_000 and table.pairs is None
    assert sorted(table.rules.values()) == list(range(256, 256 + 50_000))
    assert any(a >= 256 or b >= 256 for a, b in table.rules)
    assert not bpe.is_flat(table.rules)


def test_the_table_is_the_seeds():
    one, again, other = (learned.build(SMALL, s, CPU).rules for s in (7, 7, 8))
    assert one == again and one != other
    assert len(one) == 9000 and sorted(one.values()) == list(range(256, 9256))


def test_a_sample_too_small_is_refused():
    with pytest.raises(ValueError, match="larger"):
        learned.build({"rules": 9000, "per_round": 500, "sample_bytes": 1 << 12}, 7, CPU)


WINDOW = Window(100.0, [Job(0, 100.0, 102.0, 1, 1)], 10.0, {})
# two chunks' loops of 0.5 and 0.3 s with reads of 0.2 and 0.1 s in the 2 s
# window, and one loop before it
RECORD = [S(1, "mp.chunk", 1, 0, None, 2, 99 * SEC, 99 * SEC + 1),
          S(2, "mp.chunk", 2, 0, None, 2, 100 * SEC, int(100.5 * SEC)),
          S(3, "mp.read", 2, 0, 2, 2, int(100.1 * SEC), int(100.3 * SEC)),
          S(4, "mp.chunk", 2, 1, None, 2, 101 * SEC, int(101.3 * SEC)),
          S(5, "mp.read", 2, 1, 4, 2, 101 * SEC, int(101.1 * SEC))]
RECORDS = {"planted": types.SimpleNamespace(snapshot=lambda: RECORD),
           "empty": types.SimpleNamespace(snapshot=lambda: []),
           "without_record": types.ModuleType("logging"), "absent": None}


@pytest.mark.parametrize("program", list(RECORDS))
@pytest.mark.parametrize("name", list(READERS))
def test_the_readers(name, program, monkeypatch):
    """The share of a planted record; None without spans to read: an empty
    record, a program without it (the parent commit), none loaded."""
    if RECORDS[program] is None:
        monkeypatch.delitem(sys.modules, "blt_tpu_torch.utils.logging", raising=False)
    else:
        monkeypatch.setitem(sys.modules, "blt_tpu_torch.utils.logging", RECORDS[program])
    got = manifest.metric(name).read(WINDOW)
    if program == "planted":
        assert got == pytest.approx({"mp_loop_share": 40.0, "mp_read_wait_share": 15.0}[name])
    else:
        assert got is None


def test_the_entries(cells):
    bench = manifest.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["source"], m["layer"], m["moves"], m["unit"], m["better"]) == (
            "program_span", "multipass loop", "tokenize_MBps", "%", "lower")
        assert m["workloads"] == [CELL]
    assert [m["name"] for m in cells[CELL].per_layer] == list(READERS)
    assert {m["name"] for m in cells[CELL].end_to_end} == {"tokenize_MBps", "setup_s"}


def _small(cells):
    c = small(cells[CELL])
    c.config["table"].update(SMALL)
    c.config["chunk_size"] = "256KB"
    return c


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_of_the_cell(traced, cells, cpu_program):
    """Every job exact; traced, both readers find the loop's spans."""
    result, notes = run.run(_small(cells), 2**31 + 13, 0.3, traced, CPU)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    if traced:
        assert set(result["metrics"]) == set(READERS)
        assert 0 < result["metrics"]["mp_read_wait_share"]["value"] \
            < result["metrics"]["mp_loop_share"]["value"] <= 100
    else:
        assert set(result["metrics"]) == {"tokenize_MBps", "setup_s"}
    loops = next(n for n in notes if n.startswith("rounds a chunk"))
    assert "none" not in loops
    stages = next(n for n in notes if n.startswith("stages:"))
    assert '"mp.twin"' in stages and '"mp.passes"' in stages


def test_the_control_refuses_a_general_table(cells):
    """``reference/control.py`` cuts a flat table only: the cell has no
    control (a gap for a later benchmark change)."""
    with pytest.raises(ValueError, match="flat table"):
        run.run(_small(cells), 3, 0.3, False, CPU, control=True)
