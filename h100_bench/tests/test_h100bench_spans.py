"""The readers of the program's span record on a synthetic window, trace
and record: the shares, the clock offsets from the job ranges, and the
runs that have nothing to read."""

from __future__ import annotations

import sys
import types
from collections import namedtuple

import pytest

from h100_bench import manifest
from h100_bench.common import spans, trace
from h100_bench.common.window import Job, Window

S = namedtuple("S", "id name job batch parent thread start_ns end_ns")
NEW = ["job_setup_share", "write_busy_share", "feed_pack_share", "idle_feed_wait_share"]
SEC = 1_000_000_000


def _s(i, name, job, t0, t1, thread=1, parent=None):
    """A span from ``t0`` to ``t1`` seconds on the record's clock."""
    return S(i, name, job, None, parent, thread, int(t0 * SEC), int(t1 * SEC))


def record():
    """Two jobs of one second from 100 s: set-up 0.2 + 0.3 s, writes 0.1 s,
    packs 0.4 s, the feed waited on 0.2 s in job 1 and 0.1 s in job 2; one
    span before the window."""
    return [
        _s(1, "job", 0, 99.0, 99.5),  # a job before the window
        _s(2, "job.setup", 0, 99.0, 99.4),
        _s(10, "job", 1, 100.0, 101.0),
        _s(11, "job.setup", 1, 100.0, 100.2, parent=10),
        _s(12, "feed.pack", 1, 100.3, 100.5, thread=2),
        _s(13, "feed.get", 1, 100.05, 100.25, thread=3),
        _s(14, "write", 1, 100.6, 100.65, thread=4),
        _s(20, "job", 2, 101.0, 102.0),
        _s(21, "job.setup", 2, 101.0, 101.3, parent=20),
        _s(22, "feed.pack", 2, 101.4, 101.6, thread=2),
        _s(23, "feed.get", 2, 101.5, 101.6, thread=3),
        _s(24, "write", 2, 101.7, 101.75, thread=4),
    ]


def events(jitter=0.4):
    """The trace: the window from 1000 us for 2 s, each job's range at its
    span's start + an offset of 1000 us - 100 s (job 2 ``jitter`` us later),
    one 100 ms kernel inside job 1's feed wait, none in job 2's."""
    x = lambda cat, name, ts, dur, **kw: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)
    return [
        x("user_annotation", trace.WINDOW, 1000.0, 2e6, tid=1),
        x("user_annotation", trace.JOB, 1000.0, 1e6, tid=1),
        x("user_annotation", trace.JOB, 1e6 + 1000.0, 1e6, tid=1),
        x("user_annotation", spans.JOB_RANGE, 1000.0, 1e6, tid=1),
        x("user_annotation", spans.JOB_RANGE, 1e6 + 1000.0 + jitter, 1e6, tid=1),
        x("user_annotation", "blt_tpu_torch.job.setup", 1000.0, 2e5, tid=1),
        x("kernel", "void k(int)", 101_000.0, 100_000.0),
    ]


@pytest.fixture
def window(monkeypatch):
    monkeypatch.setitem(sys.modules, spans.RECORD_MODULE,
                        types.SimpleNamespace(snapshot=record))
    jobs = [Job(0, 100.0, 101.0, 1, 1), Job(1, 101.0, 102.0, 1, 1)]
    return Window(100.0, jobs, 10.0, {}, trace.parse(events()))


def read(name, w):
    return manifest.metric(name).read(w)


def test_the_window_keeps_its_own_spans(window):
    got = spans.window_spans(window)
    assert [s.id for s in got] == [10, 11, 12, 13, 14, 20, 21, 22, 23, 24]


@pytest.mark.parametrize("name,want", [("job_setup_share", 25.0), ("write_busy_share", 5.0),
                                       ("feed_pack_share", 20.0)])
def test_span_shares(window, name, want):
    assert read(name, window) == pytest.approx(want)


def test_offsets_pair_each_job_with_its_range(window):
    off = spans.offsets(window, spans.window_spans(window))
    assert off == {1: pytest.approx(1000.0 - 100e6), 2: pytest.approx(1000.4 - 100e6)}
    waits = spans.on_trace(spans.window_spans(window), off, "feed.get")
    assert waits[0] == (pytest.approx(51_000.0), pytest.approx(251_000.0))


def test_idle_feed_wait_share(window, capsys):
    # job 1 waits 200 ms, 100 of them with the kernel running; job 2 100 ms
    assert read("idle_feed_wait_share", window) == pytest.approx(100 * 0.2 / 2.0, rel=1e-6)
    err = capsys.readouterr().err
    assert "2 jobs" in err and "spreads 0.400 us" in err


def test_overlap():
    a = [(0.0, 10.0), (20.0, 30.0)]
    b = [(5.0, 25.0), (29.0, 40.0)]
    assert spans.overlap_us(a, b) == 11.0
    assert spans.overlap_us(a, []) == 0.0


def test_unpaired_jobs_put_nothing_on_the_trace(window):
    window.trace = trace.parse([e for e in events() if not (
        e["name"] == spans.JOB_RANGE and e["ts"] > 1e6)])
    assert spans.offsets(window, spans.window_spans(window)) is None
    assert read("idle_feed_wait_share", window) is None
    assert read("job_setup_share", window) == pytest.approx(25.0)


@pytest.mark.parametrize("program", ["absent", "without_record", "empty", "untraced"])
def test_nothing_to_read(window, monkeypatch, program):
    """No program loaded (the control), a program without the record (a
    parent commit), an empty record, and a run without the trace."""
    if program == "absent":
        monkeypatch.delitem(sys.modules, spans.RECORD_MODULE)
    elif program == "without_record":
        monkeypatch.setitem(sys.modules, spans.RECORD_MODULE, types.ModuleType("logging"))
    elif program == "empty":
        monkeypatch.setitem(sys.modules, spans.RECORD_MODULE,
                            types.SimpleNamespace(snapshot=lambda: []))
    else:
        window.trace = None
    for name in NEW:
        got = read(name, window)
        if program == "untraced" and name != "idle_feed_wait_share":
            assert got is not None, name
        else:
            assert got is None, name


def test_the_entries(window):
    """The four metrics are the cell's, read from the program's spans."""
    bench = manifest.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (m["source"], m["moves"], m["unit"], m["better"]) == (
            "program_span", "tokenize_MBps", "%", "lower")
        assert m["workloads"] == ["flat50k.text"]
    got = manifest.read_metrics([entries[n] for n in NEW], window)
    assert set(got) == set(NEW)
