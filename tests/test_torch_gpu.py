"""The torch port's CUDA kernels on the card (skipped without one).

Each kernel's wrapper is held against its plain PyTorch version on the same
CUDA tensors, exactly, and the engine and CLI against the host engine. This
file imports no JAX, so it runs on a machine that has only the port's
dependencies; tests/conftest.py imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from blt_tpu.merges import MergeTable
from blt_tpu.ops.bpe_numpy import bpe_encode_flat
from blt_tpu_torch import cli
from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.pipeline.engines import TorchEngine

pytestmark = pytest.mark.gpu

MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259, (255, 255): 0xFFFF}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _text(seed, n, alphabet=b"aabbcc \xffab"):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


def _join(results) -> bytes:
    return b"".join(bytes(memoryview(r).cast("B")) for r in results)


def test_kernels_equal_plain_versions(cuda):
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = torch.from_numpy(_text(10, (1 << 20) + 4096)).to(cuda)
    for n in (0, 1, 5000, 1 << 20, (1 << 20) + 4096):
        assert torch.equal(bpe_cuda.basic_encode(data[:n]), bpe_cuda.widen_plain(data[:n]))
        for carry, nb in ((0, -1), (1, 97), (1, 0), (0, 255)):
            c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
            s, co = bpe_cuda.flat_encode_slots(data, n, nb, table, c)
            sp, cp = bpe_cuda.flat_slots_plain(data, n, nb, table, c)
            assert torch.equal(s, sp) and torch.equal(co, cp), (n, carry, nb)
            prev = torch.tensor(0x6162, dtype=torch.int32, device=cuda)
            w, last = bpe_cuda.pack_slots(s, n, prev)
            wp, lp = bpe_cuda.pack_slots_plain(sp, n, prev)
            assert torch.equal(w, wp) and torch.equal(last, lp), (n, carry, nb)


def test_wrappers_count_launches_and_check_alignment(cuda):
    data = torch.zeros(4097, dtype=torch.uint8, device=cuda)
    bpe_cuda.reset_launches()
    bpe_cuda.basic_encode(data[:4096])
    assert bpe_cuda.launches["widen"] == 1
    with pytest.raises(ValueError, match="aligned"):
        bpe_cuda.basic_encode(data[1:])


def test_engine_streams_reuse_pinned_buffers(cuda):
    """One pinned staging buffer serves 65 batches: each upload must finish
    before the buffer is refilled, or batches would corrupt each other."""
    table = MergeTable.build(MERGES)
    hint = 4096
    data = _text(11, 64 * hint + 3)
    chunks = [data[i : i + hint] for i in range(0, data.shape[0], hint)]
    eng = TorchEngine(cuda, depth=4)
    bpe_cuda.reset_launches()
    got = _join(eng.bpe_stream(iter(chunks), table, hint))
    assert got == bpe_encode_flat(data, table).astype(">u2").tobytes()
    assert bpe_cuda.launches["flat_bpe"] == bpe_cuda.launches["pack_slots"] == 65
    got = _join(eng.basic_stream(iter(chunks), hint))
    assert got == data.astype(">u2").tobytes()
    assert bpe_cuda.launches["widen"] == 65


def test_cli_engine_torch_equals_engine_numpy(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("BLT_DEVICE_BATCH_BYTES", str(1 << 20))  # three batches
    src = tmp_path / "in.txt"
    src.write_bytes(_text(12, 3_000_000).tobytes())
    merges = tmp_path / "m.txt"
    merges.write_text("97 98\n98 99\n97 97\n255 255\n")
    for extra in ([], ["--merges", str(merges)]):
        outs = []
        for engine in ("torch", "numpy"):
            out = tmp_path / f"{engine}.bin"
            argv = ["-i", str(src), "-o", str(out), "--type", "text",
                    "--chunksize", "256KB", "--engine", engine]
            assert cli.main(argv + extra) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]
