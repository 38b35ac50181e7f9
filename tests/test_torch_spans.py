"""The span record of ``blt_tpu_torch.utils.logging``: a job run by
``run_tokenizer`` on a CPU ``TorchEngine`` under ``torch.profiler`` keeps
every span, on every thread, with its job id; the stage spans sum to
``feeder.stage_stats``; without a profiler nothing is kept and the output
is the same; the job ranges put the record on the trace's clock; and
``BLT_PROFILE`` merges the record into its trace."""

from __future__ import annotations

import ctypes
import json
import logging
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blt_tpu_torch import cli
from blt_tpu_torch.api import ByteTokenizer
from blt_tpu_torch.config import ContentType, CoreConfig
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import multipass_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_flat
from blt_tpu_torch.pipeline import engines, feeder, runner
from blt_tpu_torch.pipeline.engines import TorchEngine
from blt_tpu_torch.pipeline.runner import run_tokenizer
from blt_tpu_torch.utils import logging as spans
from blt_tpu_torch.utils import profiling

CPU = torch.device("cpu")
BATCH = 1 << 16
FLAT = {p: 256 + i for i, p in enumerate([(97, 98), (98, 99), (32, 97), (99, 32), (97, 97)])}
KINDS = {"flat": FLAT, "basic": None}
STAGES = {"flat": ("feed", "d2h", "drain"), "basic": ("feed", "drain")}
NAMES = ["job", "job.setup", "job.finish", "feed.item", "feed.put", "feed.get", "d2h.item",
         "d2h.put", "d2h.get", "drain.item", "drain.put", "drain.get", "feed.pack", "feed.h2d",
         "feed.launch", "write", "write.wait"]


def _config(src, out, table):
    config = CoreConfig.new_from_cli(input=src, output=out, chunksize="64KB",
                                     content_type=ContentType.TEXT)
    if table is not None:
        config.with_merges(table)
    return config


def _traced_run(tmp, kind):
    """A run without a profiler, then two jobs under one: the record, the
    exported trace's events, the stage stats and the batches cut."""
    src = tmp / "in.txt"
    rng = np.random.default_rng(7)
    src.write_bytes(rng.choice(np.frombuffer(b"abc aab", np.uint8), 1_200_000).tobytes())
    batches = []
    real = engines._batches

    def counted(chunks, capacity):
        for b in real(chunks, capacity):
            batches.append(b.shape[0])
            yield b

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BLT_DEVICE_BATCH_BYTES", str(BATCH))
        mp.delenv("BLT_PROFILE", raising=False)
        mp.setattr(engines, "_batches", counted)
        spans.snapshot(reset=True)
        run_tokenizer(_config(src, tmp / "plain.bin", KINDS[kind]), TorchEngine(CPU, threads=2))
        untraced = spans.snapshot(reset=True)
        batches.clear()
        feeder.stage_stats(reset=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for name in ("a", "b"):
                run_tokenizer(_config(src, tmp / f"{name}.bin", KINDS[kind]),
                              TorchEngine(CPU, threads=2))
        stats = feeder.stage_stats(reset=True)
        record = spans.snapshot(reset=True)
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = {n: (tmp / f"{n}.bin").read_bytes() for n in ("plain", "a", "b")}
    return dict(record=record, untraced=untraced, events=events, stats=stats,
                batches=list(batches), out=out)


@pytest.fixture(scope="module", params=list(KINDS))
def traced(request, tmp_path_factory):
    kind = request.param
    return kind, _traced_run(tmp_path_factory.mktemp(f"spans_{kind}"), kind)


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return _traced_run(tmp_path_factory.mktemp("spans_flat_names"), "flat")


@pytest.mark.parametrize("name", NAMES)
def test_each_span_is_kept_with_its_job_id(flat, name):
    record = flat["record"]
    jobs = sorted(s.job for s in record if s.name == "job")
    assert len(jobs) == 2 and jobs[0] != jobs[1]
    found = [s for s in record if s.name == name]
    assert {s.job for s in found} == set(jobs), name
    assert all(s.end_ns >= s.start_ns for s in found)


def test_children_lie_inside_their_parents_on_one_thread(traced):
    _, run = traced
    by_id = {s.id: s for s in run["record"]}
    assert len(by_id) == len(run["record"])
    children = [s for s in run["record"] if s.parent is not None]
    assert children
    for s in children:
        p = by_id[s.parent]
        assert p.thread == s.thread and p.job == s.job, s
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    for s in run["record"]:
        if s.name in ("job.setup", "job.finish"):
            assert by_id[s.parent].name == "job"
        if s.name in ("feed.pack", "feed.h2d", "feed.launch"):
            assert by_id[s.parent].name == "feed.item" and s.batch == by_id[s.parent].batch


def test_one_feed_pack_a_batch(traced):
    _, run = traced
    record = run["record"]
    assert len(run["batches"]) >= 6  # three or more a job
    assert Counter(s.name for s in record)["feed.pack"] == len(run["batches"])
    for job in {s.job for s in record}:
        packs = sorted(s.batch for s in record if s.job == job and s.name == "feed.pack")
        assert packs == list(range(len(packs)))


@pytest.mark.parametrize("part,field", [("item", "src_time"), ("put", "put_wait"),
                                        ("get", "get_wait")])
def test_stage_spans_sum_to_stage_stats(traced, part, field):
    kind, run = traced
    # beside the stages, the feed's count of batches packed into staging
    # (every batch on a CPU device)
    assert set(run["stats"]) == set(STAGES[kind]) | {"feed.staged"}
    for stage in STAGES[kind]:
        ns = sum(s.end_ns - s.start_ns for s in run["record"] if s.name == f"{stage}.{part}")
        assert ns / 1e9 == run["stats"][stage][field], stage


def test_stage_byte_counts(traced):
    """Each stage counts the bytes it hands on: the d2h stage the wire's,
    which the feed handed it on the device; the drain the output's."""
    kind, run = traced
    stats = run["stats"]
    out_bytes = sum(len(run["out"][n]) - 2 for n in ("a", "b"))  # less each header
    assert stats["drain"]["bytes"] == out_bytes
    assert stats["feed"]["items"] == len(run["batches"])
    if kind == "flat":
        assert stats["d2h"]["bytes"] == stats["feed"]["bytes"] > 0
    else:
        assert stats["feed"]["bytes"] >= out_bytes


def test_no_profiler_keeps_nothing_and_the_same_bytes(traced):
    _, run = traced
    assert run["untraced"] == []
    assert run["out"]["plain"] == run["out"]["a"] == run["out"]["b"]


def test_job_clock_offsets_agree(traced):
    """Each job's ``blt_tpu_torch.job`` range in the exported trace, less its
    ``job`` span's start, gives the same offset within 1 ms."""
    _, run = traced
    ranges = sorted(e["ts"] for e in run["events"]
                    if e.get("ph") == "X" and e.get("name") == "blt_tpu_torch.job")
    jobs = sorted((s for s in run["record"] if s.name == "job"), key=lambda s: s.start_ns)
    assert len(ranges) == len(jobs) == 2
    offsets = [ts - s.start_ns / 1e3 for ts, s in zip(ranges, jobs)]
    assert abs(offsets[0] - offsets[1]) < 1000.0
    names = {e.get("name") for e in run["events"] if e.get("cat") == "user_annotation"}
    assert {"blt_tpu_torch.job.setup", "blt_tpu_torch.job.finish"} <= names


class _CountingThread:
    """A stand-in for the thread-local state that counts reads of ``job``."""

    def __init__(self):
        self.reads = 0
        self.open, self.phases, self.tid = [], None, 0

    @property
    def job(self):
        self.reads += 1
        return None


def test_a_span_without_a_profiler_is_one_flag_read(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    state = _CountingThread()
    monkeypatch.setattr(spans, "_tls", state)
    before = spans.snapshot()
    with spans.span(logging.getLogger("test"), "x", batch=3):
        pass
    assert state.reads == 1
    assert spans.snapshot() == before


def test_a_job_without_a_profiler_makes_no_range(monkeypatch, tmp_path):
    def refused(*a, **k):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    monkeypatch.delenv("BLT_PROFILE", raising=False)
    spans.snapshot(reset=True)
    src = tmp_path / "in.txt"
    src.write_bytes(b"abc aab " * 1000)
    run_tokenizer(_config(src, tmp_path / "o.bin", FLAT), TorchEngine(CPU, threads=2))
    assert spans.snapshot() == [] and not spans.in_job()


def _entry(kind, src, out, merges):
    if kind == "cli":
        assert cli.main(["-i", str(src), "-o", str(out), "--merges", str(merges),
                         "--type", "text", "--engine", "numpy"]) == 0
    elif kind == "api":
        ByteTokenizer(merges=FLAT, content_type="Text", engine="numpy").tokenize_file(
            str(src), str(out))
    else:
        run_tokenizer(_config(src, out, FLAT), "numpy")


@pytest.mark.parametrize("kind", ["cli", "api", "runner"])
def test_each_entry_is_one_job(kind, tmp_path, monkeypatch):
    """``cli.main``, ``ByteTokenizer.tokenize_file`` and ``run_tokenizer``
    each open one job (the runner inside the first two joins theirs), whose
    set-up starts with the entry."""
    monkeypatch.delenv("BLT_PROFILE", raising=False)
    src = tmp_path / "in.txt"
    src.write_bytes(b"abc aab " * 1000)
    merges = tmp_path / "m.txt"
    merges.write_text("".join(f"{a} {b}\n" for a, b in FLAT))
    spans.snapshot(reset=True)
    with profile(activities=[ProfilerActivity.CPU]):
        _entry(kind, src, tmp_path / "o.bin", merges)
    record = spans.snapshot(reset=True)
    names = Counter(s.name for s in record)
    assert names["job"] == names["job.setup"] == names["job.finish"] == 1
    job = next(s for s in record if s.name == "job")
    setup = next(s for s in record if s.name == "job.setup")
    assert setup.start_ns - job.start_ns < 10_000_000  # the set-up opens with the job
    assert {s.job for s in record} == {job.job}


def test_blt_profile_merges_the_record(tmp_path, monkeypatch):
    """``BLT_PROFILE`` writes one trace holding the job's spans on the
    trace's clock, under the threads that ran them, and their names."""
    monkeypatch.setenv("BLT_DEVICE_BATCH_BYTES", str(BATCH))
    monkeypatch.setenv("BLT_PROFILE", str(tmp_path / "traces"))
    src = tmp_path / "in.txt"
    src.write_bytes(b"abc aab " * 50_000)
    spans.snapshot(reset=True)
    run_tokenizer(_config(src, tmp_path / "o.bin", FLAT), TorchEngine(CPU, threads=2))
    (path,) = (tmp_path / "traces").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    merged = [e for e in events if e.get("cat") == "blt_span"]
    assert {"feed.pack", "feed.h2d", "feed.launch", "write", "drain.get"} <= {
        e["name"] for e in merged}
    job = next(e for e in events if e.get("name") == "blt_tpu_torch.job" and e.get("ph") == "X")
    assert all(job["ts"] <= e["ts"] and e["ts"] + e["dur"] <= job["ts"] + job["dur"] + 1.0
               for e in merged)
    threads = {e["args"]["name"] for e in events
               if e.get("ph") == "M" and e.get("name") == "thread_name"
               and e["tid"] in {m["tid"] for m in merged}}
    assert {"blt-feed", "blt-d2h", "blt-drain"} <= threads


def test_merge_spans_refuses_unpaired_jobs():
    s = spans.Span(1, "job", 1, None, None, 1, 0, 10)
    trace = {"traceEvents": []}
    assert profiling.merge_spans(trace, [s]) == 0 and trace["traceEvents"] == []


def test_the_writer_thread_records_for_the_consumers_job(tmp_path):
    """``_drain_to_writer`` hands its job to the writer's thread."""
    from blt_tpu_torch.io.sources import OutputWriter

    writer = OutputWriter(tmp_path / "w.bin")
    spans.snapshot(reset=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.job(logging.getLogger("test")):
            runner._drain_to_writer(iter([b"ab", b"cd"]), writer)
    writer.close()
    record = spans.snapshot(reset=True)
    writes = [s for s in record if s.name == "write"]
    assert [s.batch for s in writes] == [0, 1]
    main = next(s for s in record if s.name == "job").thread
    assert all(s.thread != main for s in writes)
    assert (tmp_path / "w.bin").read_bytes() == b"abcd"


def test_direct_upload_spans(tmp_path, monkeypatch):
    """On the direct upload of a mapped input (the CUDA calls stood in for
    on the host) each batch still has one ``feed.pack``, and a window's
    registration is a ``feed.register`` inside the ``feed.pack`` of the
    batch that opens it; the output is the host encoder's."""

    class Host:
        windows = 0

        def register(self, ptr, nbytes):
            self.windows += 1
            return True

        def unregister(self, ptr):
            pass

        def copy(self, dst, src, nbytes):
            ctypes.memmove(dst.data_ptr(), src, nbytes)

    host = Host()
    monkeypatch.setattr(feeder, "host_calls", lambda device: host)
    monkeypatch.setattr(feeder, "WINDOW_BYTES", 4 * BATCH)
    run = _traced_run(tmp_path, "flat")
    record = run["record"]
    by_id = {s.id: s for s in record}
    registers = [s for s in record if s.name == "feed.register"]
    assert 2 * 4 <= len(registers) <= host.windows  # 1.2 MB a job: five windows or more
    assert all(by_id[s.parent].name == "feed.pack" for s in registers)
    assert {s.job for s in registers} == {s.job for s in record if s.name == "job"}
    assert Counter(s.name for s in record)["feed.pack"] == len(run["batches"])
    assert run["stats"]["feed.direct"]["items"] == len(run["batches"])
    assert "feed.staged" not in run["stats"]
    data = np.frombuffer((tmp_path / "in.txt").read_bytes(), np.uint8)
    want = bpe_encode_flat(data, MergeTable.build(FLAT)).astype(">u2").tobytes()
    assert run["out"]["plain"][2:] == run["out"]["a"][2:] == run["out"]["b"][2:] == want


GENERAL = {(97, 98): 256, (256, 99): 257, (257, 32): 258, (97, 97): 259}


@pytest.mark.parametrize("route", ["twin", "loop"])
def test_multipass_spans_and_counters(route, tmp_path, monkeypatch):
    """A general table's job under a profiler, through ``tokenize_file``:
    on either route (the plain twin, or the kernel loop's plain version on
    the CPU) each chunk's loop is one ``mp.chunk`` span on the feed's
    thread, each pass's host read an ``mp.read`` span inside one, all with
    the job's id; ``mp.<route>`` counts the chunks and their bytes,
    ``mp.passes`` the passes of ``loop_log``."""
    if route == "twin":
        monkeypatch.setenv("BLT_MULTIPASS", "xla")
    monkeypatch.setattr(runner, "select_engine", lambda *a, **k: TorchEngine(CPU, threads=2))
    src = tmp_path / "in.txt"
    src.write_bytes(np.random.default_rng(3).choice(
        np.frombuffer(b"abc aab", np.uint8), 600_000).tobytes())
    multipass_cuda.reset_launches()
    feeder.stage_stats(reset=True)
    spans.snapshot(reset=True)
    with profile(activities=[ProfilerActivity.CPU]):
        ByteTokenizer(merges=GENERAL, content_type="Text", chunk_size="256KB",
                      threads=2).tokenize_file(str(src), str(tmp_path / "o.bin"))
    record = spans.snapshot(reset=True)
    stats = feeder.stage_stats(reset=True)
    job = next(s for s in record if s.name == "job")
    by_id = {s.id: s for s in record}
    loops = [s for s in record if s.name == spans.MP_CHUNK]
    reads = [s for s in record if s.name == spans.MP_READ]
    feed = {s.thread for s in record if s.name == "feed.item"}
    assert len(loops) == len(multipass_cuda.loop_log) == 3
    assert {s.thread for s in loops} == feed and job.thread not in feed
    assert all(by_id[s.parent].name == spans.MP_CHUNK for s in reads)
    assert {s.job for s in loops + reads} == {job.job}
    passes = sum(p for p, _ in multipass_cuda.loop_log)
    assert len(reads) == passes == stats["mp.passes"]["items"] > 3
    assert (stats[f"mp.{route}"]["items"], stats[f"mp.{route}"]["bytes"]) == (3, 600_000)
    assert ("mp.loop" if route == "twin" else "mp.twin") not in stats
