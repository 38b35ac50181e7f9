"""The torch engine and its feeder against the JAX engine, on the CPU.

``TorchEngine(torch.device("cpu"))`` drives the same stream code that runs
on the card; its encoders run the kernels' plain versions because the
tensors lie on the CPU. The JAX side runs ``JaxEngine._bpe_pallas_stream``
with an interpret-mode encoder (as tests/test_pallas.py does), and the
reference algorithm ``bpe_oracle`` is the ground truth. Comparisons are
exact; inputs come from numpy ``default_rng(seed)``.
"""

import ctypes
import io
import mmap
import os
import sys
import time
import types
from unittest import mock

import numpy as np
import pytest
import torch

from blt_tpu.merges import MergeTable
from blt_tpu.ops.bpe_numpy import bpe_encode_flat
from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
from blt_tpu.ops.bpe_pallas import PallasFlatEncoder
from blt_tpu.pipeline.engines import JaxEngine
from blt_tpu_torch import server
from blt_tpu_torch.io.sources import InputSource
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda
from blt_tpu_torch.pipeline import engines as torch_engines
from blt_tpu_torch.pipeline import feeder
from blt_tpu_torch.pipeline.engines import (
    AutoStreamEngine,
    NumpyEngine,
    ShardedTorchEngine,
    TorchEngine,
    select_engine,
)
from blt_tpu_torch.pipeline.feeder import pinned_buffer, upload

CPU = torch.device("cpu")
HINT = 4096
MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259}


def _join(results) -> bytes:
    return b"".join(bytes(memoryview(r).cast("B")) for r in results)


def _chunks(data, size):
    return [data[i : i + size] for i in range(0, data.shape[0], size)]


def _data(seed, n, alphabet=b"abcabcaabbcc"):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


def test_flat_stream_equals_jax_pallas_stream_and_oracle():
    table = MergeTable.build(MERGES)
    data = _data(5, 4 * HINT + 77)
    data[HINT - 40 : HINT + 40] = 97  # a merge chain across a batch boundary
    chunks = _chunks(data, HINT)
    enc = PallasFlatEncoder(table, interpret=True, capacity_bytes=HINT, rows_per_block=8)
    jax_out = _join(JaxEngine()._bpe_pallas_stream(iter(chunks), enc, HINT))
    bpe_cuda.reset_launches()
    port_out = _join(TorchEngine(CPU).bpe_stream(iter(chunks), table, HINT))
    assert bpe_cuda.launches["flat_bpe"] == 0  # plain versions on the CPU
    oracle = tokens_to_be_bytes(bpe_encode_oracle(data.tobytes(), MERGES))
    assert port_out == jax_out == oracle


def test_flat_stream_short_and_uneven_chunks():
    """Pipe sources read short anywhere: odd chunk sizes and empty chunks
    keep the carry and the previous-slot state exact."""
    table = MergeTable.build(MERGES)
    data = _data(6, 3 * HINT, alphabet=b"aaab")
    rng = np.random.default_rng(6)
    cuts = np.sort(rng.integers(1, data.shape[0], 9))
    chunks = np.split(data, cuts) + [data[:0]]
    got = _join(TorchEngine(CPU, depth=1).bpe_stream(iter(chunks), table, HINT))
    assert got == bpe_encode_flat(data, table).astype(">u2").tobytes()


def test_basic_stream_equals_widen():
    data = _data(7, 3 * HINT + 5, alphabet=bytes(range(256)))
    got = _join(TorchEngine(CPU).basic_stream(iter(_chunks(data, HINT)), HINT))
    assert got == data.astype(">u2").tobytes()
    host = _join(NumpyEngine(1).basic_stream(iter(_chunks(data, HINT)), HINT))
    assert got == host


def test_passthrough_stream_is_identity():
    data = _data(8, 1000)
    got = _join(TorchEngine(CPU).passthrough_stream(iter(_chunks(data, 300)), 300))
    assert got == data.tobytes()


def test_twin_route_for_tables_the_kernel_rejects():
    """Flat tables with values < 256 go through bpe_torch.flat_encode,
    chosen by supports() alone."""
    merges = {(97, 98): 90, (98, 99): 7}
    table = MergeTable.build(merges)
    assert table.flat and not bpe_cuda.CudaFlatEncoder.supports(table)
    data = _data(9, 3 * HINT + 11)
    got = _join(TorchEngine(CPU).bpe_stream(iter(_chunks(data, HINT)), table, HINT))
    assert got == tokens_to_be_bytes(bpe_encode_oracle(data.tobytes(), merges))


def test_general_tables_stream():
    """The table that used to raise NotImplementedError now streams through
    the multipass encoder, chunk by chunk (per-chunk semantics)."""
    merges = {(97, 98): 256, (256, 99): 257}
    table = MergeTable.build(merges)
    assert not table.flat
    chunks = _chunks(_data(1, 3 * HINT + 10), HINT)
    multipass_cuda.reset_launches()
    got = _join(TorchEngine(CPU).bpe_stream(iter(chunks), table, HINT))
    assert multipass_cuda.launches == dict.fromkeys(
        ["token_pass_gap", *multipass_cuda.TOKEN_PASSES], 0)
    assert len(multipass_cuda.loop_log) == len(chunks)
    expected = b"".join(
        tokens_to_be_bytes(bpe_encode_oracle(c.tobytes(), merges)) for c in chunks
    )
    assert got == expected


def test_upload_returns_a_copy_the_buffer_can_be_reused():
    buf = pinned_buffer(64, CPU)
    assert buf.dtype == torch.uint8 and buf.shape == (64,)
    buf.numpy()[:] = 7
    dev = upload(buf, CPU)
    buf.numpy()[:] = 9  # the next batch overwrites the buffer
    assert dev.tolist() == [7] * 64
    assert upload(np.arange(5, dtype=np.uint8), CPU).tolist() == list(range(5))


def test_select_engine_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert isinstance(select_engine("numpy", 10), NumpyEngine)
    assert isinstance(select_engine("auto", 10), NumpyEngine)
    assert isinstance(select_engine("auto", 1 << 30), NumpyEngine)
    assert isinstance(select_engine("auto", None), AutoStreamEngine)
    with pytest.raises(RuntimeError, match="CUDA"):
        select_engine("torch", 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine("cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        select_engine("jax", 10)


def test_select_engine_with_a_device(monkeypatch):
    """AUTO takes the torch engine for large inputs when a device exists
    (the probe is stubbed to hand back a CPU-backed engine)."""
    monkeypatch.setattr(
        torch_engines, "_probe_device_engine", lambda threads=0: TorchEngine(CPU)
    )
    assert isinstance(select_engine("auto", 1 << 30), TorchEngine)
    assert isinstance(select_engine("auto", 100), NumpyEngine)


def test_auto_stream_engine_peeks_then_commits(monkeypatch):
    table = MergeTable.build(MERGES)
    data = _data(10, 2 * HINT)
    expected = bpe_encode_flat(data, table).astype(">u2").tobytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = AutoStreamEngine(mem_budget=HINT)
    assert _join(eng.bpe_stream(iter(_chunks(data, 1000)), table, HINT)) == expected
    assert isinstance(eng.selected, NumpyEngine)
    monkeypatch.setattr(
        torch_engines, "_probe_device_engine", lambda threads=0: TorchEngine(CPU)
    )
    eng = AutoStreamEngine(mem_budget=HINT)
    assert _join(eng.bpe_stream(iter(_chunks(data, 1000)), table, HINT)) == expected
    assert isinstance(eng.selected, TorchEngine)


# --- the direct upload of a mapped input ---------------------------------------
#
# On a CUDA device a batch of a file mapping goes to the card from the mapping
# itself (``feeder.MappedWindows``). Here ``FakeHost`` stands in for the three
# CUDA calls (the seam ``feeder.host_calls``), so the CPU engine runs the same
# bookkeeping: registrations are ranges, a copy is a memmove that must read
# inside a registered one. ``WINDOW`` is cut from 64 MiB to four pages.

WINDOW = 4 * mmap.PAGESIZE


class FakeHost:
    """Registers by range, refusing the attempts numbered in ``refuse``; the
    registration of a range that overlaps a registered one fails too, as
    in CUDA."""

    def __init__(self, refuse=()):
        self.refuse = set(refuse)
        self.attempts = []  # (lo, hi) of every register call, in order
        self.live = {}  # lo -> hi, registered now
        self.unregistered = []
        self.copies = []  # (src, nbytes)
        self.most = 0  # most ranges registered at once

    def register(self, ptr, nbytes):
        assert ptr % mmap.PAGESIZE == 0 and nbytes % mmap.PAGESIZE == 0 and nbytes > 0
        assert all(ptr + nbytes <= lo or hi <= ptr for lo, hi in self.live.items())
        ok = len(self.attempts) not in self.refuse
        self.attempts.append((ptr, ptr + nbytes))
        if ok:
            self.live[ptr] = ptr + nbytes
            self.most = max(self.most, len(self.live))
        return ok

    def unregister(self, ptr):
        self.unregistered.append((ptr, self.live.pop(ptr)))

    def copy(self, dst, src, nbytes):
        assert any(lo <= src and src + nbytes <= hi for lo, hi in self.live.items())
        assert dst.numel() >= nbytes
        self.copies.append((src, nbytes))
        ctypes.memmove(dst.data_ptr(), src, nbytes)


@pytest.fixture
def fake_host(monkeypatch):
    host = FakeHost()
    monkeypatch.setattr(feeder, "host_calls", lambda device: host)
    monkeypatch.setattr(feeder, "WINDOW_BYTES", WINDOW)
    feeder.stage_stats(reset=True)
    return host


def _mapped_file(tmp_path, n, seed=21):
    data = _data(seed, n, alphabet=b"abcab caabbccaaab")
    path = tmp_path / f"in{n}.bin"
    path.write_bytes(data.tobytes())
    return data, path


GENERAL = {(97, 98): 256, (256, 99): 257, (97, 97): 258}
STREAMS = {
    "basic": (lambda e, c: e.basic_stream(c, HINT), lambda d: d.astype(">u2").tobytes()),
    "flat": (lambda e, c: e.bpe_stream(c, MergeTable.build(MERGES), HINT),
             lambda d: tokens_to_be_bytes(bpe_encode_oracle(d.tobytes(), MERGES))),
    "general": (lambda e, c: e.bpe_stream(c, MergeTable.build(GENERAL), HINT),
                lambda d: b"".join(tokens_to_be_bytes(bpe_encode_oracle(
                    d[i : i + HINT].tobytes(), GENERAL)) for i in range(0, d.shape[0], HINT))),
}


def _twin_stream(engine, chunks):
    """The general stream on the plain twin, the route of a table cuckoo32
    cannot place."""
    with mock.patch.dict(os.environ, {"BLT_MULTIPASS": "xla"}):
        yield from engine.bpe_stream(chunks, MergeTable.build(GENERAL), HINT)


STREAMS["twin"] = (_twin_stream, STREAMS["general"][1])
# a mapped input of 0 bytes, 1, one batch, one window and 1 byte, and several
# windows with a short tail
SIZES = [0, 1, HINT, WINDOW + 1, 3 * WINDOW + 777]


@pytest.mark.parametrize("kind", list(STREAMS))
@pytest.mark.parametrize("size", SIZES)
def test_mapped_input_windows(fake_host, tmp_path, kind, size):
    """Each batch is copied from a registered window that covers it; each
    window is registered and unregistered once, at most two at a time, and
    none is left; the output equals the oracle's."""
    data, path = _mapped_file(tmp_path, size)
    stream, want = STREAMS[kind]
    got = _join(stream(TorchEngine(CPU), InputSource(path).chunks(HINT)))
    assert got == want(data)
    batches = -(-size // HINT)
    assert len(fake_host.copies) == batches
    assert sum(n for _, n in fake_host.copies) == size
    assert fake_host.live == {} and 0 < fake_host.most <= 2 if size else fake_host.most == 0
    assert sorted(fake_host.unregistered) == sorted(fake_host.attempts)
    assert len(set(fake_host.attempts)) == len(fake_host.attempts) == -(-size // WINDOW)
    for lo, hi in fake_host.attempts:
        assert hi - lo == min(WINDOW, -(-(size - (lo - fake_host.attempts[0][0]))
                                        // mmap.PAGESIZE) * mmap.PAGESIZE)
    stats = feeder.stage_stats()
    if size:
        assert stats["feed.direct"] == dict.fromkeys(feeder._TIMES, 0.0) | {
            "items": batches, "bytes": size}
    assert "feed.staged" not in stats and "feed.register_failed" not in stats


def test_a_window_spans_a_batch_longer_than_it(fake_host, tmp_path):
    """A window starts at the page of its first batch's first byte and
    spans the batch when the batch is longer than ``WINDOW_BYTES``; the
    window registered ahead starts where it ends and stops at the
    mapping's last page."""
    data, path = _mapped_file(tmp_path, 3 * WINDOW + 5)
    mapped = np.memmap(path, dtype=np.uint8, mode="r")
    base = mapped.ctypes.data
    windows = feeder.MappedWindows(CPU)
    with windows:
        for lo, hi in ((100, 2 * WINDOW + 100), (2 * WINDOW + 100, 2 * WINDOW + 300),
                       (3 * WINDOW, 3 * WINDOW + 5)):
            dev = windows.upload(mapped[lo:hi], 4 * WINDOW)
            assert dev.shape == (4 * WINDOW,)
            assert bytes(dev[: hi - lo].numpy()) == data[lo:hi].tobytes()
    page = mmap.PAGESIZE
    assert [(lo - base, hi - base) for lo, hi in fake_host.attempts] == [
        (0, 2 * WINDOW + page), (2 * WINDOW + page, 3 * WINDOW + page)]
    assert fake_host.live == {} and fake_host.most == 2
    assert sorted(fake_host.unregistered) == sorted(fake_host.attempts)


@pytest.mark.parametrize("kind", list(STREAMS))
def test_batches_across_window_edges(fake_host, tmp_path, kind):
    """Batches that are no multiple of a page straddle the window edges:
    each such batch opens its own window, never one that overlaps a window
    still registered (``FakeHost`` refuses that), and the output is the
    oracle's."""
    size = 5 * WINDOW + 999
    data, path = _mapped_file(tmp_path, size)
    stream, want = STREAMS[kind]
    got = _join(stream(TorchEngine(CPU), InputSource(path).chunks(3001)))
    if kind in ("general", "twin"):  # per-chunk semantics: the oracle's chunks are 3001 bytes
        want = lambda d: b"".join(tokens_to_be_bytes(bpe_encode_oracle(
            d[i : i + 3001].tobytes(), GENERAL)) for i in range(0, d.shape[0], 3001))
    assert got == want(data)
    assert len(fake_host.copies) == -(-size // 3001)
    assert fake_host.live == {} and fake_host.most == 2
    assert len(set(fake_host.attempts)) == len(fake_host.attempts) > -(-size // WINDOW)
    assert sorted(fake_host.unregistered) == sorted(fake_host.attempts)
    assert feeder.stage_stats()["feed.direct"]["items"] == len(fake_host.copies)


def test_windows_released_when_the_job_raises(fake_host, tmp_path):
    data, path = _mapped_file(tmp_path, 3 * WINDOW)

    def chunks():
        yield from InputSource(path).chunks(HINT * 5)
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        _join(STREAMS["flat"][0](TorchEngine(CPU), chunks()))
    assert len(fake_host.attempts) >= 2
    assert fake_host.live == {}
    assert sorted(fake_host.unregistered) == sorted(fake_host.attempts)


@pytest.mark.parametrize("kind", list(STREAMS))
def test_windows_released_when_the_consumer_abandons(fake_host, tmp_path, kind):
    _, path = _mapped_file(tmp_path, 6 * WINDOW)
    stream = STREAMS[kind][0](TorchEngine(CPU, depth=1), InputSource(path).chunks(HINT))
    next(stream)
    stream.close()
    deadline = time.monotonic() + 10
    while fake_host.live and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fake_host.attempts and fake_host.live == {}
    assert sorted(fake_host.unregistered) == sorted(fake_host.attempts)


def test_a_refused_window_takes_the_staging_copy(fake_host, tmp_path):
    """CUDA refuses the second window: its batches are packed into
    staging and counted as such, the others still go direct, and the
    output is the same bytes."""
    fake_host.refuse = {1}
    size = 3 * WINDOW + 777
    data, path = _mapped_file(tmp_path, size)
    got = _join(STREAMS["flat"][0](TorchEngine(CPU), InputSource(path).chunks(HINT)))
    assert got == STREAMS["flat"][1](data)
    stats = feeder.stage_stats()
    per_window = WINDOW // HINT
    assert stats["feed.register_failed"]["items"] == 1
    assert stats["feed.staged"]["items"] == per_window
    assert stats["feed.staged"]["bytes"] == WINDOW
    assert stats["feed.direct"]["items"] == -(-size // HINT) - per_window
    assert len(fake_host.attempts) == 4 and fake_host.live == {}
    assert sorted(fake_host.unregistered) == sorted(fake_host.attempts[:1] + fake_host.attempts[2:])


def _staged_only(fake_host, got, want, batches):
    assert got == want
    stats = feeder.stage_stats()
    assert "feed.direct" not in stats and "feed.register_failed" not in stats
    assert stats["feed.staged"]["items"] >= batches > 0
    assert fake_host.attempts == [] and fake_host.copies == []


def test_stdin_takes_the_staging_copy(fake_host, monkeypatch):
    data = _data(22, 3 * HINT + 5)
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(buffer=io.BytesIO(data.tobytes())))
    stream, want = STREAMS["flat"]
    got = _join(stream(TorchEngine(CPU), InputSource(None).chunks(HINT)))
    _staged_only(fake_host, got, want(data), 4)


def test_in_memory_bytes_take_the_staging_copy(fake_host):
    data = _data(23, 3 * HINT + 5)
    got = server.tokenize_bytes_wire(data.tobytes(), MergeTable.build(MERGES),
                                     engine=TorchEngine(CPU))
    _staged_only(fake_host, got, STREAMS["flat"][1](data), 1)


@pytest.mark.parametrize("kind", ["basic", "flat"])
def test_sharded_rows_take_the_staging_copy(fake_host, tmp_path, kind):
    data, path = _mapped_file(tmp_path, 3 * WINDOW + 777)
    stream, want = STREAMS[kind]
    engine = ShardedTorchEngine(devices=[CPU] * 2)
    got = _join(stream(engine, InputSource(path).chunks(HINT)))
    _staged_only(fake_host, got, want(data), 2)


def test_a_cpu_device_takes_the_staging_copy(tmp_path):
    """Without the seam stood in for, a CPU device never registers."""
    feeder.stage_stats(reset=True)
    data, path = _mapped_file(tmp_path, 2 * HINT + 3)
    got = _join(STREAMS["flat"][0](TorchEngine(CPU), InputSource(path).chunks(HINT)))
    assert got == STREAMS["flat"][1](data)
    stats = feeder.stage_stats()
    assert stats["feed.staged"]["items"] == 3 and "feed.direct" not in stats
