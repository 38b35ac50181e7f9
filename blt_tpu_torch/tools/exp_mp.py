"""Host compaction against the device-resident sort loop on a pass-heavy 8-rule table.

    python -m blt_tpu_torch.tools.exp_mp [--size-mib 4] [--reps 3] [--k 1] [--seed 3]
        [--device cuda|cpu]

Port of ``tools/exp_mp.py``. Its 8-rule hierarchical table, whose chains
force about 8 rounds, on ``--size-mib`` MiB drawn from its 19-letter
alphabet (``default_rng(--seed)``, the original's 3):

- ``host_compaction``: ``CudaTokenEncoder.encode``, K4 a round with the
  tombstones compacted on the host (the tokens cross the link twice a
  round);
- ``device_resident``: the sort loop, ``CudaTokenEncoder._sort_loop``
  reached through ``encode_resident_dispatch`` under
  ``BLT_MP_COMPACT=sort`` (K4 a round, then ``bpe_torch._compact`` on the
  card), with the upload of the input bytes and the download of the tokens;
- ``device_compute_only``: the same loop on an input already on the card,
  its count read on the host.

Each is timed by the wall clock (``_common.time_wall``): ``--k`` samples of
``--reps`` calls back to back (the original took one sample of 3). The
original's five keys (``exact_host``, ``exact_device``,
``host_compaction_mb_s``, ``device_resident_mb_s``,
``device_compute_only_mb_s``, each rate the median sample's) sit beside the
rows and the rounds the loop took (``multipass_cuda.loop_log``). The
oracle is ``bpe_numpy.bpe_encode_multipass``; ``bound_ms`` is the bytes the
loop must move (each round reads its live int32 tokens and writes the
survivors) over the card's memory rate. One JSON line; exits 1 when a
result differs from the oracle's.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import multipass_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_multipass
from blt_tpu_torch.ops.multipass_cuda import CudaTokenEncoder
from blt_tpu_torch.tools import _common as C

K = 1  # samples (the original's one)
REPS = 3  # calls back to back a sample (the original's --reps)
SIZE_MIB = 4
SEED = 3
ALPHABET = b"abcabccdabcd abcabc"
# pass-heavy hierarchical table: chains force ~8 rounds (the original's)
MERGES = {(97, 98): 256, (256, 99): 257, (257, 257): 258,
          (258, 258): 259, (259, 100): 260, (32, 97): 261,
          (260, 261): 262, (262, 262): 263}


def alphabet_data(rng: np.random.Generator, n: int) -> np.ndarray:
    """The original's input: ``n`` bytes drawn from its alphabet."""
    return rng.choice(np.frombuffer(ALPHABET, np.uint8), size=n).astype(np.uint8)


def sort_loop(enc: CudaTokenEncoder, data):
    """The resident sort loop through the dispatch a user calls:
    (compacted tokens on the device, the count)."""
    with C.env("BLT_MP_COMPACT", "sort"):
        return enc.encode_resident_dispatch(data)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = SEED,
            reps: int = REPS) -> dict:
    """The three rows on ``device``; see the module docstring."""
    table = MergeTable.build(MERGES)
    data = alphabet_data(np.random.default_rng(seed), size_bytes)
    t0 = time.perf_counter()
    expected = bpe_encode_multipass(data, table)
    oracle_s = time.perf_counter() - t0
    bound = C.loop_bytes(C.rounds_host(data, table)[1])
    enc = CudaTokenEncoder(table, device, capacity_tokens=size_bytes)

    def exact(got) -> bool:
        return got.shape == expected.shape and bool((got == expected).all())

    t0 = time.perf_counter()
    first_host = exact(enc.encode(data))
    first_host_s = time.perf_counter() - t0
    host, got = C.time_wall(lambda: enc.encode(data), size_bytes, device, reps=k, pipe=reps,
                            force=None, warm=False)
    exact_host = first_host and exact(got)

    def resident():  # the upload, the loop, the download of its tokens
        toks, m = sort_loop(enc, data)
        m = int(m)
        return toks[:m].cpu().numpy(), m

    t0 = time.perf_counter()
    first_device = exact(resident()[0])
    first_device_s = time.perf_counter() - t0
    rounds = multipass_cuda.loop_log[-1][0]
    dev_timing, (got, _) = C.time_wall(resident, size_bytes, device, reps=k, pipe=reps,
                                       force=None, warm=False)
    exact_device = first_device and exact(got)
    data_d = torch.from_numpy(data).to(device)
    compute, (toks, m) = C.time_wall(lambda: sort_loop(enc, data_d), size_bytes, device,
                                     reps=k, pipe=reps, warm=False)
    exact_compute = exact(toks[: int(m)].cpu().numpy())

    rows = [C.wall_row("host_compaction", "K4", host, bound, exact_host, first_s=first_host_s),
            C.wall_row("device_resident", "K4", dev_timing, bound, exact_device,
                       first_s=first_device_s),
            C.wall_row("device_compute_only", "K4", compute, bound, exact_compute)]
    rate = {r["name"]: r["wall"]["MB_per_s"]["median"] for r in rows}
    return {"tool": "exp_mp", "device": C.describe(device), "size_bytes": size_bytes,
            "rules": len(MERGES), "seed": seed, "reps": reps, "tokens_out": int(expected.size),
            "oracle_s": oracle_s, "rounds": rounds,
            "exact_host": exact_host, "exact_device": exact_device,
            "host_compaction_mb_s": rate["host_compaction"],
            "device_resident_mb_s": rate["device_resident"],
            "device_compute_only_mb_s": rate["device_compute_only"],
            "exact": all(r["exact"] for r in rows), "rows": rows}


def main(argv=None) -> int:
    ap = C.parser(__doc__.splitlines()[0], K, SIZE_MIB, "samples of --reps calls")
    ap.add_argument("--reps", type=int, default=REPS,
                    help=f"calls back to back a sample (default {REPS}, the original's)")
    ap.set_defaults(seed=SEED)
    args = ap.parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed,
                     args.reps)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
