"""The metric arithmetic on a synthetic trace and synthetic counters."""

from __future__ import annotations

import json

import pytest

from h100_bench import manifest
from h100_bench.common import peaks, trace
from h100_bench.common.window import Job, Window

K3 = ("void (anonymous namespace)::tile_lookback<true>(GapPass, int*, int*, "
      "unsigned long long*, int*)")
K4 = "void (anonymous namespace)::tile_lookback(Pass, int*, unsigned long long*)"
GLUE = ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
        "std::array<char*, 1ul> >(int, at::native::FillFunctor<int>, std::array<char*, 1ul>)")
CAT = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
       "namespace)::OpaqueType<4u>, unsigned int, 1, 128, 1>(int)")


def events():
    """A 10 ms window: K3 1 ms, glue 1 ms, a 2 MB DtoH in 2 ms, a memset,
    and host calls; one kernel half outside the window."""
    x = lambda cat, name, ts, dur, **kw: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)
    return [
        x("user_annotation", trace.WINDOW, 1000.0, 10000.0, tid=1),
        x("user_annotation", trace.JOB, 1000.0, 6000.0, tid=1),
        x("user_annotation", trace.JOB, 7000.0, 4000.0, tid=1),
        x("kernel", K3, 1000.0, 1000.0),
        x("kernel", GLUE, 2000.0, 500.0),
        x("kernel", CAT, 2500.0, 500.0),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 4000.0, 2000.0, args={"bytes": 2_000_000}),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 6000.0, 500.0, args={"bytes": 9}),
        x("gpu_memset", "Memset (Device)", 6500.0, 100.0),
        x("kernel", K3, 10500.0, 1000.0),  # half in the window
        x("cuda_runtime", "cudaStreamSynchronize", 3000.0, 1000.0, tid=2),
        x("cuda_runtime", "cudaMalloc", 3100.0, 100.0, tid=2),
        x("cpu_op", "aten::copy_", 8000.0, 2000.0, tid=3),
        {"ph": "M", "name": "thread_name"},
    ]


@pytest.fixture
def window():
    t = trace.parse(events())
    jobs = [Job(0, 0.0, 6.0, 1_000_000, 500_000), Job(0, 6.0, 10.0, 1_000_000, 500_000)]
    stages = {"feed": {"items": 3, "src_time": 4.0, "put_wait": 1.0, "get_wait": 0.5},
              "d2h": {"items": 3, "src_time": 3.0, "put_wait": 0.0, "get_wait": 2.0},
              "drain": {"items": 3, "src_time": 7.0, "put_wait": 0.0, "get_wait": 0.1}}
    return Window(0.0, jobs, 12.5, stages, t)


def read(name, w):
    return manifest.metric(name).read(w)


def test_names():
    assert trace.qualified(K3) == "tile_lookback"
    assert trace.qualified(GLUE) == "at::native::vectorized_elementwise_kernel"
    assert trace.qualified(CAT) == "at::native::CatArrayBatchedCopy"
    assert trace.short(K3) == "tile_lookback(GapPass)" and trace.short(K4) == "tile_lookback(Pass)"


def test_device_time(window):
    t = window.trace
    assert t.window_s == pytest.approx(0.010)
    # K3 1 + glue 1 + DtoH 2 + HtoD 0.5 + memset 0.1 + the K3 half 0.5 ms
    assert trace.busy_s(t) == pytest.approx(0.0051)
    assert trace.d2h(t) == (2_000_000, pytest.approx(0.002))
    assert trace.kernel_seconds(t) == pytest.approx(0.0025)
    ops = dict((k, v) for k, v in trace.device_ops(t))
    assert ops["tile_lookback(GapPass)"] == pytest.approx(0.0015)
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(0.002)


def test_idle_gaps(window):
    gaps = trace.idle_gaps(window.trace)
    assert [round(s, 6) for _, s in gaps] == [0.0039, 0.001]
    assert gaps[0][0] == "aten::copy_, after Memset (Device)"
    assert gaps[1][0] == "cudaStreamSynchronize, after CatArrayBatchedCopy(int)"


def test_readers(window):
    assert read("tokenize_MBps", window) == pytest.approx(2.0 / 10.0)
    assert read("setup_s", window) == 12.5
    assert read("drain_busy_share", window) == pytest.approx(100 * (7.0 - 2.0) / 10.0)
    assert read("feed_busy_share", window) == pytest.approx(40.0)
    roof = 100 * 3_000_000 / peaks.HBM_BYTES_PER_S / 0.0025
    assert read("kernels_roofline", window) == pytest.approx(roof)
    assert read("device_idle_share", window) == pytest.approx(49.0)
    assert read("d2h_GBps", window) == pytest.approx(1.0)


def test_readers_with_nothing_to_read(window):
    window.trace = None
    window.stages = {}
    window.jobs = window.jobs[:1]
    for name in ("drain_busy_share", "feed_busy_share",
                 "kernels_roofline", "device_idle_share", "d2h_GBps"):
        assert read(name, window) is None, name
    bench = manifest.load()
    out = manifest.read_metrics(bench["per_layer"], window)
    assert out == {}


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.parse([e for e in events() if e.get("name") != trace.WINDOW])


def test_load_round_trip(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events()}))
    assert trace.busy_s(trace.load(p)) == pytest.approx(0.0051)
