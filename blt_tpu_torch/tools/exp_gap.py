"""K3's gap round chained at the main path's shape: 16 Mi tokens, 8192 slots.

    python -m blt_tpu_torch.tools.exp_gap [--size-mib 16] [--k 8] [--seed 0]
        [--device cuda|cpu]

K3 (``csrc/token_pass_gap.cu``, ``multipass_cuda.token_pass_gap``) is the
round of the default resident loop. Here it runs on ``--size-mib`` Mi
tokens of the corpus (one token per byte, as ``chip_smoke.py`` and the
device-rate tools make it from the seed) with leg 4's general table
(``hierarchical_rules``: 8000 rules that cuckoo32 places at 8192 slots),
chained k times with each round's output fed back as the next input, so
tombstones arrive from the second round on. One row, timed as launched and
as a CUDA-graph replay beside the plain version and the bound (tokens read
and written, the planes and the count, once each). One JSON line, as
``exp_chain``; exits 1 when a timed result differs from the plain chain's.

The script uses only entry points that earlier versions of the package
have too, so it also times another checkout's K3 in the same run:

    cd OTHER && PYTHONPATH=$PWD python3 /path/to/blt_tpu_torch/tools/exp_gap.py
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import multipass_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_multipass
from blt_tpu_torch.ops.tables import cuckoo_planes
from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_mp_ablate import feed_back

K = 8
SIZE_MIB = 16


def hierarchical_rules(corpus: np.ndarray, rounds: int = 16, per_round: int = 500) -> dict:
    """Leg 4's general table, built from the corpus: ``rounds`` rounds, each
    adding the ``per_round`` most frequent token pairs of the first 1 MiB
    after the rounds before (new tokens 256, 257, ...), so later rules merge
    merged tokens."""
    toks = corpus[: C.MIB].astype(np.int64)
    rules = {}
    for _ in range(rounds):
        pairs, counts = np.unique((toks[:-1] << 16) | toks[1:], return_counts=True)
        for p in pairs[np.argsort(-counts, kind="stable")][:per_round]:
            rules[(int(p) >> 16, int(p) & 0xFFFF)] = 256 + len(rules)
        toks = bpe_encode_multipass(toks, MergeTable.build(rules)).astype(np.int64)
    return rules


def gap_row(tokens: torch.Tensor, planes, k: int = K) -> dict:
    """K3 chained k times over ``tokens`` (int32, -1 = dead) with ``planes``."""
    device = tokens.device
    n = tokens.numel()
    planes_bytes = 4 * 4 * planes.slots
    return {
        "name": "gap_round", "kernel": "K3", "tokens": n, "slots": planes.slots,
        **C.time_chain(
            lambda: feed_back(lambda t: multipass_cuda.token_pass_gap(t, planes), tokens, k),
            k, 4 * n, device,
            feed_back(lambda t: multipass_cuda.token_pass_gap_plain(t, planes), tokens, k)),
        # tokens read and written, the planes and the count, once each
        "bound_ms": C.bound_ms(8 * n + planes_bytes + 4), "bound_by": "bytes",
        "plain_ms": C.median_ms(
            lambda: multipass_cuda.token_pass_gap_plain(tokens, planes), device),
        "library_ms": None,
    }


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """Leg 4's table and ``size_bytes`` tokens of the corpus on ``device``;
    see the module docstring."""
    # a whole number of the recipe's 4 MiB periods: the same first bytes as
    # chip_smoke.py's corpus from the same seed
    period = 4 * C.MIB
    corpus = C.make_corpus(np.random.default_rng(seed), -(-max(size_bytes, 1) // period) * period)
    rules = hierarchical_rules(corpus)
    planes = cuckoo_planes(MergeTable.build(rules), device)
    if planes is None:
        raise RuntimeError(f"cuckoo32 cannot place the {len(rules)}-rule table")
    tokens = torch.from_numpy(corpus[:size_bytes].astype(np.int32)).to(device)
    row = gap_row(tokens, planes, k)
    return {"tool": "exp_gap", "device": C.describe(device), "size_bytes": size_bytes,
            "rules": len(rules), "slots": planes.slots, "seed": seed, "exact": row["exact"],
            "rows": [row]}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K, SIZE_MIB).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
