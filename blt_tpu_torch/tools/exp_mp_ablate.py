"""Stage ablation of the general-table token pass, at 8 Mi tokens.

    python -m blt_tpu_torch.tools.exp_mp_ablate [--size-mib 8] [--k 8] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_mp_ablate.py`` (T4). Five variants of K4's merge round
over int32 tokens; the first four are flag sets of K4's own round
(``csrc/token_pass.cu``, ``multipass_cuda.token_pass``), the copy is
``csrc/token_parts.cu`` (``tools_cuda.copy_tokens``):

- ``full``: K4's function (K4 itself);
- ``noscan``: every match starts (no parity scan; one launch);
- ``nolookup``: a pair "matches" when ``(d ^ next) & 7 == 3`` and merges to
  ``d + 1``, then the scan;
- ``noshift``: each token pairs with itself (no neighbour shift);
- ``copy``: out = tokens, the floor of the bytes.

Each is chained k times with its output fed back as the next input (so -1
tombstones arrive from the second link on), over ``--size-mib`` Mi tokens
of the corpus (one token per byte) and the original's four-rule
hierarchical table. The original also sweeps rows_per_block 256, 512 and
1024 on ``full``; rows_per_block sets nothing on the card (the tile is fixed
and no output depends on it), so those rows time the same kernel and say
so in ``rpb``. Beside them, no new kernel: the original's compaction glue
under the same chains (``sortkv``: a sort by the unique keys ``i`` for a
live token, ``cap + i`` for one with ``v & 7 == 3``, 4 times; ``cumsum``:
``cumsum(v & 1)`` in int32, k times), K3 chained k times through its -1
tail (``gapsweep``, the original's ``main_gap``, at rows_per_block 512 and
1024) and K4 chained the same way (``plain_control``). ``copy`` is timed
beside ``clone()``.

One JSON line, as ``exp_chain``, plus the stage split against ``full``;
exits 1 when a timed result differs from its plain version's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda, tools_cuda
from blt_tpu_torch.ops.tables import cuckoo_planes
from blt_tpu_torch.tools import _common as C

K = 8
SIZE_MIB = 8
SORT_K = 4
HIER = {(97, 98): 256, (256, 99): 257, (257, 257): 258, (32, 97): 259}
# the variants in the original's order: a merge round's switches, or None
# for the copy
VARIANTS = {"full": multipass_cuda.TOKEN_PASSES["token_pass"],
            **{v: multipass_cuda.TOKEN_PASSES[f"token_parts_{v}"]
               for v in ("noscan", "nolookup", "noshift")},
            "copy": None}


def _flags(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {tuple(VARIANTS)}")
    return VARIANTS[variant]


def token_parts(variant: str, tokens, n: int, planes):
    """One round of a T4 variant: kernel on CUDA tensors, plain on CPU
    tensors. tokens: int32[cap], valid in [0, n). Returns int32[cap]."""
    flags = _flags(variant)
    if flags is None:
        return tools_cuda.copy_tokens(tokens)
    return multipass_cuda.token_pass(tokens, n, planes, flags)


def token_parts_plain(variant: str, tokens, n: int, planes):
    """``token_parts`` as plain tensor ops."""
    flags = _flags(variant)
    if flags is None:
        return tools_cuda.copy_tokens_plain(tokens)
    return multipass_cuda.token_pass_plain(tokens, n, planes, flags)


def feed_back(step, x, k: int):
    """k calls of ``step``, each fed what the call before returned (its
    first element where it returns a tuple, as K3 does); the last result.
    The original's chains (``chained_call``, ``gap_chain``, ``sort_chain``,
    ``cumsum_chain``)."""
    def link(t):
        out = step(t)
        return out, out[0] if isinstance(out, tuple) else out

    return bpe_cuda.chain_passes(link, x, k)[0]


def chain(variant: str, tokens, n: int, planes, k: int = K):
    """k rounds of a T4 variant, each fed the round before's output."""
    return feed_back(lambda t: token_parts(variant, t, n, planes), tokens, k)


def chain_plain(variant: str, tokens, n: int, planes, k: int = K):
    """``chain`` through the plain version."""
    return feed_back(lambda t: token_parts_plain(variant, t, n, planes), tokens, k)


def sortkv_step(v: torch.Tensor) -> torch.Tensor:
    """One link of the original's ``sort_chain``: the values ordered by the
    unique keys ``i`` (live) or ``cap + i`` (``v & 7 == 3``)."""
    iota = torch.arange(v.numel(), dtype=torch.int64, device=v.device)
    keys = torch.where((v & 7) != 3, iota, v.numel() + iota)
    return v[torch.sort(keys).indices]


def sortkv_host(v: np.ndarray, k: int) -> np.ndarray:
    """``sortkv_step`` k times in NumPy (a stable partition)."""
    for _ in range(k):
        dead = (v & 7) == 3
        v = np.concatenate([v[~dead], v[dead]])
    return v


def cumsum_step(v: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(v & 1, 0, dtype=torch.int32)


def cumsum_host(v: np.ndarray, k: int) -> np.ndarray:
    for _ in range(k):
        v = np.cumsum(v & 1, dtype=np.int32)
    return v


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The five variants, the rows_per_block rows and the glue and K3 / K4
    chains on ``device``; see the module docstring."""
    host = C.make_corpus(np.random.default_rng(seed), size_bytes).astype(np.int32)
    tokens = torch.from_numpy(host).to(device)
    planes = cuckoo_planes(MergeTable.build(HIER), device)
    plane_bytes = 4 * 4 * planes.slots
    cap = n = tokens.numel()
    rows = []

    def row(name, kernel, run, expect, kk, bound_bytes, plain=None, rpb=None, library=None):
        rows.append({
            "name": name, "kernel": kernel, "rpb": rpb,
            **C.time_chain(run, kk, 4 * cap, device, expect),
            "bound_ms": C.bound_ms(bound_bytes), "bound_by": "bytes",
            "plain_ms": C.median_ms(plain, device) if plain else None,
            "library_ms": library,
        })

    for variant, rpb in [(v, 512) for v in VARIANTS] + [("full", 256), ("full", 1024)]:
        expect = (chain_plain(variant, tokens, n, planes, k),)
        library = (C.chained_ms(lambda: (tokens.clone(),), k, 4 * cap, device, (tokens,))
                   if variant == "copy" else None)
        row(variant, "T4", lambda variant=variant: (chain(variant, tokens, n, planes, k),),
            expect, k, 8 * cap + (0 if variant == "copy" else plane_bytes),
            plain=lambda variant=variant: token_parts_plain(variant, tokens, n, planes),
            rpb=rpb, library=library)

    # the compaction glue, checked against NumPy
    row("sortkv", None, lambda: (feed_back(sortkv_step, tokens, SORT_K),),
        (torch.from_numpy(sortkv_host(host, SORT_K)).to(device),), SORT_K, 8 * cap)
    row("cumsum", None, lambda: (feed_back(cumsum_step, tokens, k),),
        (torch.from_numpy(cumsum_host(host, k)).to(device),), k, 8 * cap)

    # K3 through a -1 tail, and K4, under the same chain (main_gap)
    for rpb in (512, 1024):
        row("gapsweep", "K3",
            lambda: feed_back(lambda t: multipass_cuda.token_pass_gap(t, planes), tokens, k),
            feed_back(lambda t: multipass_cuda.token_pass_gap_plain(t, planes), tokens, k),
            k, 8 * cap + plane_bytes + 4,
            plain=lambda: multipass_cuda.token_pass_gap_plain(tokens, planes), rpb=rpb)
    row("plain_control", "K4",
        lambda: (feed_back(lambda t: multipass_cuda.token_pass(t, n, planes, _flags("full")),
                           tokens, k),),
        (feed_back(lambda t: multipass_cuda.token_pass_plain(t, n, planes), tokens, k),),
        k, 8 * cap + plane_bytes,
        plain=lambda: multipass_cuda.token_pass_plain(tokens, n, planes), rpb=512)

    ms = {(r["name"], r["rpb"]): (r["graph"] or r["eager"])["ms_per_launch"]["median"]
          for r in rows}
    full = ms[("full", 512)]
    split = {"scan_ms": full - ms[("noscan", 512)], "lookup_ms": full - ms[("nolookup", 512)],
             "shift_ms": full - ms[("noshift", 512)], "copy_ms": ms[("copy", 512)],
             "full_ms": full}
    return {"tool": "exp_mp_ablate", "device": C.describe(device), "size_bytes": size_bytes,
            "tokens": cap, "rules": len(HIER), "slots": planes.slots, "seed": seed,
            "exact": all(r["exact"] for r in rows), "rows": rows, "split": split}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K, SIZE_MIB).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
