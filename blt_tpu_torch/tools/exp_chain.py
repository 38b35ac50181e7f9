"""Device rates of chained launches: copy, widen and the flat-BPE pass.

    python -m blt_tpu_torch.tools.exp_chain [--size-mib 64] [--k 96] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_chain.py``. Each chain is k launches that each take the
token (or carry) the launch before wrote, enqueued with no host sync in
between, so its time is the device's rate without per-call host overhead:

- ``copy`` and ``widen`` at rows_per_block 2048 (and ``widen`` at 8192):
  T1, ``copy_chain`` / ``widen_chain`` (``csrc/chain.cu``);
- ``basic_chained``: K5, ``bpe_cuda.basic_encode_chained`` at
  rows_per_block 2048, what ``bench.py`` times for its basic headline;
- ``bpe``: K2 chained ``BPE_K`` = 24 times through its carry
  (``bpe_chain``; bench.py's ``K_BPE``, where the original chains 96) over
  the corpus with its 500 most frequent pairs.

On the card rows_per_block fixes only the token (``tok + k * (rows // rpb
- 1)``); the grid is sized to the card. Each chain is timed as launched
and as a CUDA-graph replay (``_common.time_chain``). One JSON line: per
chain, ms per launch and GB/s of input bytes (median, IQR), the byte bound,
the plain version's ms per launch, the one PyTorch call of the same
function (``library_ms``: ``clone()`` on the copy row, ``widen_call`` on the
widen and ``basic_chained`` rows, each held equal to the kernel's output),
and whether every timed result equals the plain chain's (``exact``). Exits
1 when one does not.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common as C

K = 96
BPE_K = 24


def widen_call(data: torch.Tensor) -> torch.Tensor:
    """The widen as one PyTorch call: each byte b padded with a 0 byte in
    front, ``00 b``, read as u16, the little-endian image of ``b << 8``.
    uint8 of any shape -> uint16 of its shape."""
    return torch.nn.functional.pad(data.reshape(-1, 1), (1, 0)).view(torch.uint16).reshape(
        data.shape)


def copy_chain_plain(data2, tok, rpb: int = 2048, k: int = K):
    """T1 copy as plain tensor ops: (a copy of data2, the last token)."""
    return bpe_cuda.chain_plain("chain_copy", data2, tok, k, rpb)


def widen_chain_plain(data2, tok, rpb: int = 2048, k: int = K):
    """T1 widen as plain tensor ops: (data2 << 8 as u16, the last token)."""
    return bpe_cuda.chain_plain("chain_widen", data2, tok, k, rpb)


def copy_chain(data2, tok, rpb: int = 2048, k: int = K):
    """k u8 copies chained through a device token (T1 ``copy_chain``):
    kernel on CUDA tensors, plain on CPU tensors. Returns (last out,
    last token int32 (1,1))."""
    return bpe_cuda.chain_encode("chain_copy", data2, tok, k, rpb)


def widen_chain(data2, tok, rpb: int = 2048, k: int = K):
    """k widens chained through a device token (T1 ``widen_chain``): K5's
    function, counted as T1."""
    return bpe_cuda.chain_encode("chain_widen", data2, tok, k, rpb)


def bpe_chain(data, n: int, table, carry, k: int = BPE_K):
    """K2 k times over one batch, chained through its carry; returns the
    last (slots, carry)."""
    return bpe_cuda.flat_encode_chained(data, n, -1, table, carry, k)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """Every chain of this tool on ``device``; see the module docstring."""
    corpus = C.make_corpus(np.random.default_rng(seed), size_bytes)
    data = torch.from_numpy(corpus).to(device)
    data2 = data.reshape(-1, C.LANES)
    tok = torch.full((1, 1), 5, dtype=torch.int32, device=device)
    n = size_bytes
    rows = []

    def row(name, kernel, rpb, fn, plain, k, out_bytes, library=None):
        """fn(j) / plain(j): a chain of j launches, kernel and plain;
        library: the one PyTorch call of the same function, held equal to
        the kernel's output."""
        timing = C.time_chain(lambda: fn(k), k, n, device, plain(k))
        rows.append({
            "name": name, "kernel": kernel, "rpb": rpb, **timing,
            "bound_ms": C.bound_ms(n + out_bytes),
            "plain_ms": C.median_ms(lambda: plain(1), device),
            "library_ms": (C.chained_ms(lambda: (library(data2),), k, n, device, (fn(1)[0],))
                           if library else None),
        })

    for rpb, fn, plain in (
        (2048, copy_chain, copy_chain_plain),
        (2048, widen_chain, widen_chain_plain),
        (8192, widen_chain, widen_chain_plain),
    ):
        copy = fn is copy_chain
        row("copy" if copy else "widen", "T1", rpb,
            lambda j, fn=fn, rpb=rpb: fn(data2, tok, rpb, j),
            lambda j, plain=plain, rpb=rpb: plain(data2, tok, rpb, j),
            k, n if copy else 2 * n, library=torch.clone if copy else widen_call)
    row("basic_chained", "K5", 2048,
        lambda j: bpe_cuda.basic_encode_chained(data2, tok, j, 2048),
        lambda j: bpe_cuda.basic_chained_plain(data2, tok, j, 2048),
        k, 2 * n, library=widen_call)

    table = wire_table(C.frequent_pair_table(corpus).dense, device)
    carry = torch.zeros((1, 1), dtype=torch.int32, device=device)
    row("bpe", "K2", None, lambda j: bpe_chain(data, n, table, carry, j),
        lambda j: bpe_cuda.chain_passes(
            lambda c: bpe_cuda.flat_pass_plain(data, n, -1, table, c), carry, j),
        BPE_K, 2 * n + table.numel() * 2)
    return {"tool": "exp_chain", "device": C.describe(device), "size_bytes": n,
            "rules": C.RULES, "seed": seed, "exact": all(r["exact"] for r in rows),
            "rows": rows}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
