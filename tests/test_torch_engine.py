"""The torch engine and its feeder against the JAX engine, on the CPU.

``TorchEngine(torch.device("cpu"))`` drives the same stream code that runs
on the card; its encoders run the kernels' plain versions because the
tensors lie on the CPU. The JAX side runs ``JaxEngine._bpe_pallas_stream``
with an interpret-mode encoder (as tests/test_pallas.py does), and the
reference algorithm ``bpe_oracle`` is the ground truth. Comparisons are
exact; inputs come from numpy ``default_rng(seed)``.
"""

import numpy as np
import pytest
import torch

from blt_tpu.merges import MergeTable
from blt_tpu.ops.bpe_numpy import bpe_encode_flat
from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
from blt_tpu.ops.bpe_pallas import PallasFlatEncoder
from blt_tpu.pipeline.engines import JaxEngine
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda
from blt_tpu_torch.pipeline import engines as torch_engines
from blt_tpu_torch.pipeline.engines import (
    AutoStreamEngine,
    NumpyEngine,
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
