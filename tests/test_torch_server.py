"""The torch port's HTTP server, engine choice, warm-up and profiling,
against the JAX package's, on the CPU.

Each pair of servers holds one table: the JAX server on its NumPy engine,
the port's on ``TorchEngine(torch.device("cpu"))``, whose encoders run the
kernels' plain versions because the tensors lie on the CPU. Both get the
same raw HTTP requests and must give the same status, ``Content-Type`` and
body (tolerance zero). The tables cover every route of a request on the
card: none (K1), a flat table whose values are all >= 256 (K2 fused with
its pack), a flat table with a value < 256 (the twin route), a general
hierarchical table (the K3 loop, and the K4 loop under
``BLT_MP_COMPACT=sort``). Inputs come from numpy ``default_rng(seed)``.
"""

import concurrent.futures
import json
import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from blt_tpu import merges as jax_merges
from blt_tpu import server as jax_server
from blt_tpu.ops import decode as jax_decode
from blt_tpu.pipeline import engines as jax_engines
from blt_tpu_torch import server as port_server
from blt_tpu_torch import warmup
from blt_tpu_torch.config import ContentType, CoreConfig, Mode
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import _cuda_build, bpe_cuda, multipass_cuda, tools_cuda
from blt_tpu_torch.pipeline import engines as port_engines
from blt_tpu_torch.pipeline.engines import (
    DEVICE_HINT_FLOOR,
    NumpyEngine,
    PayloadAutoEngine,
    ShardedTorchEngine,
    TorchEngine,
    device_capacity_hint,
)
from blt_tpu_torch.pipeline.runner import run_tokenizer

CPU = torch.device("cpu")
FLAT_PAIRS = [(97, 98), (98, 99), (32, 97), (99, 32), (97, 97)]
TABLES = {
    "basic": None,
    "flat": {p: 256 + i for i, p in enumerate(FLAT_PAIRS)},  # the K2 route
    "twin": {(97, 98): 256, (98, 99): 90, (32, 97): 300},  # a value < 256
    "general": {(97, 98): 256, (256, 99): 257, (257, 257): 300, (32, 256): 301,
                (99, 97): 258, (258, 98): 259},  # hierarchical: K3 / K4
}


def _text(seed, n, alphabet=b"aabbcc ab"):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8).tobytes()


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _pair(kind, tmp_path):
    """(JAX server, port server), both serving ``TABLES[kind]``. A flat table
    comes from a merges file, as the CLI's does; the JAX server takes the
    others through its handler's table (its ``make_server`` reads files
    only, and a file holds only flat tables)."""
    rules = TABLES[kind]
    if kind == "flat":
        path = tmp_path / "merges.txt"
        path.write_text("".join(f"{a} {b}\n" for a, b in FLAT_PAIRS))
        jax = jax_server.make_server(port=0, merges_path=path, engine="numpy")
        port = port_server.make_server(port=0, merges_path=path, engine=TorchEngine(CPU))
    else:
        jax = jax_server.make_server(port=0, engine="numpy")
        port = port_server.make_server(
            port=0, engine=TorchEngine(CPU),
            table=None if rules is None else MergeTable.build(rules))
        if rules is not None:
            handler = jax.RequestHandlerClass
            handler.table = jax_merges.MergeTable.build(rules)
            try:
                handler.exp_table = jax_decode.build_expansion_table(rules)
            except ValueError:
                handler.exp_table = None  # as make_server: /detokenize reports it
    return _start(jax), _start(port)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("servers")
    pairs = {kind: _pair(kind, tmp) for kind in TABLES}
    yield {kind: tuple(s.server_address for s in pair) for kind, pair in pairs.items()}
    for pair in pairs.values():
        for srv in pair:
            srv.shutdown()
            srv.server_close()


def _raw(method, path, body=b"", headers=None):
    """One HTTP/1.0 request as bytes; ``headers`` None sends Content-Length."""
    if headers is None:
        headers = {"Content-Length": str(len(body))}
    lines = [f"{method} {path} HTTP/1.0"] + [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def _exchange(addr, raw):
    """Send ``raw`` and read to EOF. Returns (status, Content-Type, body)."""
    with socket.create_connection(addr, timeout=60) as s:
        s.sendall(raw)
        s.shutdown(socket.SHUT_WR)
        data = b""
        while chunk := s.recv(1 << 16):
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    fields = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split()[1]), fields.get("Content-Type"), body


def _tokenize_then(seed, n, query=""):
    """A /detokenize request of the JAX server's tokens of a text."""
    def body(addrs):
        _, _, wire = _exchange(addrs[0], _raw("POST", f"/tokenize{query}", _text(seed, n)))
        return wire
    return body


# (table, method, path, body or a function of the servers' addresses, raw
# headers or None, the expected status)
CASES = {
    "health": ("basic", "GET", "/health", b"", None, 200),
    "version": ("basic", "GET", "/version", b"", None, 200),
    "get_unknown_path": ("basic", "GET", "/nope", b"", None, 404),
    "basic": ("basic", "POST", "/tokenize", _text(1, 3001, bytes(range(256))), None, 200),
    "basic_large": ("basic", "POST", "/tokenize?type=bin", _text(2, 70000, bytes(range(256))),
                    None, 200),
    "empty": ("basic", "POST", "/tokenize", b"", None, 200),
    "empty_typed": ("flat", "POST", "/tokenize?type=text", b"", None, 200),
    "empty_general": ("general", "POST", "/tokenize?type=video", b"", None, 200),
    **{f"type_{t}": ("flat", "POST", f"/tokenize?type={t}", _text(3, 500), None, 200)
       for t in ("text", "audio", "bin", "video")},
    "passthrough": ("flat", "POST", "/tokenize?mode=passthrough", _text(4, 900), None, 200),
    "passthrough_typed": ("basic", "POST", "/tokenize?mode=passthrough&type=bin", b"raw",
                          None, 200),
    "flat": ("flat", "POST", "/tokenize", _text(5, 5000), None, 200),
    "flat_across_a_bucket": ("flat", "POST", "/tokenize?type=text",
                             _text(6, DEVICE_HINT_FLOOR + 3), None, 200),
    "twin": ("twin", "POST", "/tokenize", _text(7, 4000), None, 200),
    "general": ("general", "POST", "/tokenize?type=text", _text(8, 6000), None, 200),
    "general_one_byte": ("general", "POST", "/tokenize", b"a", None, 200),
    "detokenize_basic": ("basic", "POST", "/detokenize",
                         _tokenize_then(9, 700), None, 200),
    "detokenize_flat": ("flat", "POST", "/detokenize?type=text",
                        _tokenize_then(10, 3000, "?type=text"), None, 200),
    "detokenize_general": ("general", "POST", "/detokenize",
                           _tokenize_then(11, 3000), None, 200),
    "detokenize_twin_not_invertible": ("twin", "POST", "/detokenize", b"\x00a", None, 400),
    "detokenize_odd": ("flat", "POST", "/detokenize", b"\x00", None, 400),
    "detokenize_invalid_token": ("flat", "POST", "/detokenize", b"\x01\x2c", None, 400),
    "detokenize_wrong_header": ("flat", "POST", "/detokenize?type=text",
                                b"\xff\x02\x00\x61", None, 400),
    "detokenize_missing_header": ("flat", "POST", "/detokenize?type=audio", b"", None, 400),
    "bad_mode": ("flat", "POST", "/tokenize?mode=warp", b"x", None, 400),
    "bad_type": ("flat", "POST", "/tokenize?type=smell", b"x", None, 400),
    "post_unknown_path": ("flat", "POST", "/nope", b"x", None, 404),
    "chunked": ("flat", "POST", "/tokenize", b"", {"Transfer-Encoding": "chunked"}, 411),
    "malformed_length": ("flat", "POST", "/tokenize", b"", {"Content-Length": "ten"}, 400),
    "negative_length": ("flat", "POST", "/tokenize", b"", {"Content-Length": "-4"}, 400),
    "no_length": ("basic", "POST", "/tokenize?type=text", b"", {}, 200),
}


@pytest.mark.parametrize("name", CASES)
def test_request_equals_the_jax_server(servers, name):
    kind, method, path, body, headers, status = CASES[name]
    addrs = servers[kind]
    if callable(body):
        body = body(addrs)
    raw = _raw(method, path, body, headers)
    jax, port = (_exchange(a, raw) for a in addrs)
    assert jax[0] == status
    assert port == jax


def test_general_table_under_sort_equals_the_jax_server(servers, monkeypatch):
    """The K4 route: the port's stream reads BLT_MP_COMPACT per request."""
    monkeypatch.setenv("BLT_MP_COMPACT", "sort")
    multipass_cuda.loop_log.clear()
    for seed, n in ((12, 5000), (13, 1), (14, 129)):
        raw = _raw("POST", "/tokenize?type=text", _text(seed, n))
        jax, port = (_exchange(a, raw) for a in servers["general"])
        assert jax[0] == 200 and port == jax
    # one sort loop a request: a round and a compaction each time
    assert len(multipass_cuda.loop_log) == 3
    assert all(r == c for r, c in multipass_cuda.loop_log)


def _mixed_requests(seed, count):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        kind = ("basic", "flat", "twin", "general")[i % 4]
        n = int(rng.choice([0, 1, 17, 4096, 20000, DEVICE_HINT_FLOOR + 1]))
        query = rng.choice(["", "?type=text", "?mode=passthrough", "?type=bin"])
        out.append((kind, _raw("POST", f"/tokenize{query}", _text(seed + i, n))))
    return out


def test_eight_concurrent_clients_equal_the_jax_server(servers):
    """Eight client threads, 64 requests of mixed sizes, tables and modes, to
    the port's servers at once; each answer equals the JAX server's to the
    same request. The launch counters stay consistent (no launch on the
    CPU)."""
    requests = _mixed_requests(20, 64)
    expected = [_exchange(servers[kind][0], raw) for kind, raw in requests]
    before = {m: dict(m.launches) for m in (bpe_cuda, multipass_cuda, tools_cuda)}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda r: _exchange(servers[r[0]][1], r[1]), requests))
    finally:
        sys.setswitchinterval(switch)
    assert [g[0] for g in expected] == [200] * 64
    assert got == expected
    assert {m: dict(m.launches) for m in before} == before


def test_launch_counts_are_exact_under_threads():
    """``_cuda_build.count``, which every wrapper calls where it launches,
    loses no update when threads count at once."""
    launches = {"a": 0, "b": 0}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(5000):
                _cuda_build.count(launches, "a")
                _cuda_build.count(launches, "b", 3)
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert launches == {"a": 16 * 5000, "b": 16 * 5000 * 3}
    _cuda_build.reset_counts(launches)
    assert launches == {"a": 0, "b": 0}


# --- the engine choice --------------------------------------------------------


class _JaxDev:
    name = "jax"


class _JaxShard:
    name = "shard"


class _Named:
    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("size", [0, 1, 1000, DEVICE_HINT_FLOOR - 1, DEVICE_HINT_FLOOR,
                                  DEVICE_HINT_FLOOR + 1, 100_000, 120_000, (1 << 20) + 5,
                                  (16 << 20) + 1])
def test_device_capacity_hint_equals_the_jax_function(size):
    assert DEVICE_HINT_FLOOR == jax_engines.DEVICE_HINT_FLOOR
    for port_name, jax_engine in (("torch", _JaxDev()), ("shard", _JaxShard())):
        got = device_capacity_hint(size, _Named(port_name))
        assert got == jax_engines.device_capacity_hint(size, jax_engine)
        assert got >= size  # a general table's request is never cut
    assert device_capacity_hint(size, NumpyEngine()) == size
    assert device_capacity_hint(size, _Named("auto")) == size


def test_payload_auto_routes_by_threshold(monkeypatch):
    """Below the threshold the host engine, at or above it the device engine
    (here a CPU TorchEngine), probed once; every answer equals the JAX
    package's."""
    probes = []

    def probe(threads=0):
        probes.append(threads)
        return TorchEngine(CPU, threads=threads)

    monkeypatch.setattr(port_engines, "_probe_device_engine", probe)
    auto = PayloadAutoEngine(threads=2, device_threshold=1024)
    assert auto.threshold == 1024
    assert PayloadAutoEngine().threshold == jax_engines.AUTO_DEVICE_THRESHOLD
    assert auto.select(100).name == "numpy"
    assert probes == []  # no probe for a small payload
    bpe_cuda.reset_launches()
    table = MergeTable.build(TABLES["flat"])
    jax_table = jax_merges.MergeTable.build(TABLES["flat"])
    for n in (100, 1023, 1024, 5000):
        data = _text(30 + n, n)
        for tbl, jtbl in ((None, None), (table, jax_table)):
            got = port_server.tokenize_bytes_wire(data, table=tbl, engine=auto)
            want = jax_server.tokenize_bytes_wire(data, table=jtbl,
                                                  engine=jax_engines.NumpyEngine())
            assert got == want
    assert auto.select(1024).name == "torch" and auto.select(1023).name == "numpy"
    assert probes == [2]  # probed once, with the engine's threads


def test_payload_auto_probes_once_under_threads(monkeypatch):
    probes = []
    gate = threading.Event()

    def probe(threads=0):
        gate.wait(5)
        probes.append(1)
        return TorchEngine(CPU)

    monkeypatch.setattr(port_engines, "_probe_device_engine", probe)
    auto = PayloadAutoEngine(device_threshold=10)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futures = [pool.submit(auto.select, 100) for _ in range(8)]
        gate.set()
        engines = [f.result(timeout=30) for f in futures]
    assert probes == [1]
    assert len({id(e) for e in engines}) == 1 and engines[0].name == "torch"


def test_payload_auto_without_a_card_serves_on_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    auto = PayloadAutoEngine(device_threshold=10)
    assert auto.select(1000).name == "numpy"
    assert auto.select(5).name == "numpy"
    data = _text(40, 3000)
    assert port_server.tokenize_bytes_wire(data, engine=auto) == \
        np.frombuffer(data, np.uint8).astype(">u2").tobytes()
    srv = port_server.make_server(port=0, engine="auto", device_threshold=10)
    try:
        assert srv.RequestHandlerClass.engine.name == "auto"
    finally:
        srv.server_close()


@pytest.mark.parametrize("argv", [
    [],  # the default engine is torch
    ["--engine", "torch"],
    ["--engine", "shard"],
    ["--engine", "torch", "--warmup", "1MB"],
])
def test_server_main_without_cuda_exits_1(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_server.main(argv + ["--port", "0"]) == 1
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--device-threshold", "12GB"], ["--warmup", "1.5XB"],
                                  ["--engine", "numpy", "--merges", "/nonexistent/m.txt"]])
def test_server_main_bad_arguments_exit_1(argv, capsys):
    assert port_server.main(argv + ["--port", "0", "--engine", "numpy"]) == 1
    assert jax_server.main(argv + ["--port", "0"]) == 1
    assert "Error starting server" in capsys.readouterr().err


def test_device_engine_names_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch", "shard"):
        with pytest.raises(RuntimeError, match="CUDA"):
            port_server.make_server(port=0, engine=name)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_server.tokenize_bytes_wire(b"abc")  # the default engine is the card's
    with pytest.raises(ValueError, match="unknown engine"):
        port_server.make_server(port=0, engine="jax")


# --- warm-up ------------------------------------------------------------------


class _FakeStreams:
    def __init__(self, name, calls):
        self.name = name
        self.calls = calls

    def bpe_stream(self, chunks, table, hint):
        self.calls.append(hint)
        return iter(())

    def basic_stream(self, chunks, hint):
        self.calls.append(hint)
        return iter(())


class _FakeAuto:
    name = "auto"

    def __init__(self, threshold, device):
        self.threshold = threshold
        self.device = device

    def select(self, size):
        return self.device


@pytest.mark.parametrize("max_bytes", [0, 1, DEVICE_HINT_FLOOR, 4 * DEVICE_HINT_FLOOR,
                                       4 * DEVICE_HINT_FLOOR + 1, 1 << 20])
@pytest.mark.parametrize("threshold", [None, 2 * DEVICE_HINT_FLOOR, 1 << 30])
def test_warmup_visits_the_jax_servers_buckets(max_bytes, threshold):
    """``_warmup`` runs one payload per power-of-two bucket, as the JAX
    server's (its fake-engine test); under AUTO only the buckets at or
    above the threshold, and none when the threshold is above them all."""
    jax_calls, port_calls = [], []
    jax_eng, port_eng = _FakeStreams("jax", jax_calls), _FakeStreams("torch", port_calls)
    if threshold is not None:
        jax_eng, port_eng = _FakeAuto(threshold, jax_eng), _FakeAuto(threshold, port_eng)
    jax_server._warmup(jax_eng, None, max_bytes)
    port_server._warmup(port_eng, None, max_bytes)
    assert port_calls == jax_calls
    if threshold is None:
        assert port_calls == warmup.pow2_buckets(max_bytes)


def test_warmup_skips_host_engines():
    calls = []
    port_server._warmup(_FakeStreams("numpy", calls), None, 1 << 20)
    port_server._warmup(_FakeAuto(1, _FakeStreams("numpy", calls)), None, 1 << 20)
    assert calls == []


@pytest.mark.parametrize("mode", list(Mode))
def test_warm_shapes_is_zero_off_cuda(mode):
    table = MergeTable.build(TABLES["general"])
    assert warmup.warm_shapes(mode, table, [1 << 16, 1 << 20], CPU) == 0
    assert warmup.warm_for_run(mode, table, 1 << 20, CPU, 1 << 20, full=True) == 0


def test_warm_for_run_raises_where_it_fails(monkeypatch):
    """A warm-up that cannot reach the card raises; it does not carry on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        warmup.warm_for_run(Mode.BASIC, None, 1 << 20, torch.device("cuda", 0), 1 << 20)


def _run(tmp_path, kind, engine, name, **kw):
    src = tmp_path / "in.txt"
    if not src.exists():
        src.write_bytes(_text(50, 300_000))
    out = tmp_path / f"{name}.bin"
    config = CoreConfig.new_from_cli(input=src, output=out, chunksize="64KB",
                                     content_type=ContentType.TEXT, **kw)
    if TABLES[kind] is not None:
        config.with_merges(TABLES[kind])
    run_tokenizer(config, engine=engine)
    return out.read_bytes()


def _jax_run(tmp_path, kind):
    from blt_tpu.config import ContentType as JaxContentType
    from blt_tpu.config import CoreConfig as JaxCoreConfig
    from blt_tpu.config import Engine as JaxEngine
    from blt_tpu.pipeline.runner import run_tokenizer as jax_run_tokenizer

    out = tmp_path / "jax.bin"
    config = JaxCoreConfig.new_from_cli(input=tmp_path / "in.txt", output=out,
                                        chunksize="64KB", content_type=JaxContentType.TEXT,
                                        engine=JaxEngine.NUMPY)
    if TABLES[kind] is not None:
        config.with_merges(TABLES[kind])
    jax_run_tokenizer(config)
    return out.read_bytes()


@pytest.mark.parametrize("kind", ["basic", "flat", "general"])
@pytest.mark.parametrize("warm", ["1", "full"])
def test_runner_under_blt_warmup_writes_the_same_bytes(tmp_path, monkeypatch, kind, warm):
    monkeypatch.setenv("BLT_DEVICE_BATCH_BYTES", str(1 << 16))
    engine = TorchEngine(CPU)
    plain = _run(tmp_path, kind, engine, "plain")
    calls = []
    real = warmup.warm_for_run
    monkeypatch.setattr(warmup, "warm_for_run",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    monkeypatch.setenv("BLT_WARMUP", warm)
    assert _run(tmp_path, kind, engine, "warm") == plain
    assert plain == _jax_run(tmp_path, kind)
    # the run's feed capacity on the engine's device, the grid under full
    (args, kwargs), = calls
    assert args[3] == CPU and kwargs == {"full": warm == "full"}


def test_runner_does_not_warm_the_sharded_engine(tmp_path, monkeypatch):
    """The sharded engine is a TorchEngine; the runner tests for it first and
    does not warm it as one device."""
    monkeypatch.setenv("BLT_DEVICE_BATCH_BYTES", str(1 << 16))
    monkeypatch.setenv("BLT_WARMUP", "1")
    calls = []
    monkeypatch.setattr(warmup, "warm_for_run", lambda *a, **k: calls.append(a))
    out = _run(tmp_path, "flat", ShardedTorchEngine(devices=[CPU] * 2), "shard")
    assert calls == []
    monkeypatch.delenv("BLT_WARMUP")
    assert out == _run(tmp_path, "flat", TorchEngine(CPU), "one")


def test_runner_warmup_failure_fails_the_run(tmp_path, monkeypatch):
    monkeypatch.setenv("BLT_WARMUP", "1")

    def broken(*a, **k):
        raise RuntimeError("kernel library failed to build")

    monkeypatch.setattr(warmup, "warm_for_run", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        _run(tmp_path, "basic", TorchEngine(CPU), "broken")
    assert not (tmp_path / "broken.bin").exists()  # the partial output is removed


# --- profiling ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["basic", "flat"])
def test_blt_profile_leaves_one_trace_and_the_same_bytes(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("BLT_DEVICE_BATCH_BYTES", str(1 << 16))
    plain = _run(tmp_path, kind, TorchEngine(CPU), "plain")
    traces = tmp_path / "traces"
    monkeypatch.setenv("BLT_PROFILE", str(traces))
    assert _run(tmp_path, kind, TorchEngine(CPU), "traced") == plain
    files = list(traces.iterdir())
    assert len(files) == 1 and files[0].name.startswith("blt_trace_")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert events  # host activity, at least


def test_blt_profile_unset_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("BLT_PROFILE", raising=False)
    from blt_tpu_torch.utils.profiling import maybe_profile

    before = set(os.listdir(tmp_path))
    with maybe_profile(CPU):
        pass
    assert set(os.listdir(tmp_path)) == before


def test_blt_profile_traces_decode(tmp_path, monkeypatch):
    wire = _run(tmp_path, "flat", TorchEngine(CPU), "wire")
    monkeypatch.setenv("BLT_PROFILE", str(tmp_path / "traces"))
    config = CoreConfig.new_from_cli(input=tmp_path / "wire.bin", output=tmp_path / "back.bin",
                                     content_type=ContentType.TEXT, decode=True)
    config.with_merges(TABLES["flat"])
    run_tokenizer(config)
    assert (tmp_path / "back.bin").read_bytes() == (tmp_path / "in.txt").read_bytes()
    assert len(list((tmp_path / "traces").iterdir())) == 1
    assert wire
