"""Smoke test of the torch port's main path on one CUDA card.

    python3 chip_smoke.py [--seed N] [--size-mib 1024]

Run from the root of a checkout on a machine with a CUDA device. It
imports nothing of JAX or of the JAX package. One JSON line per phase:

1. device: fails without CUDA; prints ``nvidia-smi``'s name and power limit;
2. build: compiles ``blt_tpu_torch/csrc/*.cu`` with nvcc (one process per
   source, in parallel); prints what ptxas reports for T14's two kernels,
   ``chain.cu``'s, T9's (``subgather.cu``) and K3's (registers, spills,
   shared memory), and for the main path's three one-launch look-back
   kernels (K3, K4 and K2 fused with its pack) the CTAs per SM the CUDA
   runtime's occupancy query gives, counts T14's ``wgmma`` instructions
   (``IGMMA``, ``HGMMA``), the copy ring's bulk copies (``UBLKCP``) and T9's slab
   kernels' TMA loads (``UTMALDG``) in the library's SASS (``cuobjdump``),
   failing on none; ptxas's registers and spills and the CTAs per SM of
   the redesigned tool kernels (T13's four lookup instantiations, g2d
   running chain's, T6's two segment scans, T12's two mask scans, T3's and
   T11's eight probes, T10's ``noscan2``, T5's int16 and int8 mixes), the
   bulk copies of T13's three lookups that stage a table and of T6's two
   scans, failing on none, and every opcode's count in T5's two packed
   kernels; builds
   the 8000-rule hierarchical table of leg 4 and checks on the host that
   cuckoo32 places it at 8192 slots;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   same CUDA tensors, exactly (tolerance 0: every value is an integer
   token), over the edge cases of the flat pass and of the token passes
   (among them lengths 0, 1, 7, 8, 4095, 4096 and 4097, a merge starting on
   a tile's last position, carry_in 1 and a prev_slot that is a merge
   start): K2 and its pack, K2 fused with its pack into one launch
   (``flat_bpe_packed``, the main path's), K3, and K4 as one look-back
   launch (``token_pass_lookback``, the main path's) and as three; median
   times at 16 MiB (16 Mi tokens for the token passes) beside the least
   time the card could take (bytes over 3.35 TB/s), the fused pass beside
   K2 then the pack, and K1's beside the one PyTorch call of its function
   (``exp_chain.widen_call``), held equal to it; K3, and K4 in both
   designs, chained 8 times through their own output at 16 Mi tokens with
   leg 4's table, replayed from a CUDA graph (``exp_gap.gap_row``,
   ``exp_lookback.k4_rows``); K3 and K4 also on tables of 9000 and 50,000
   rules learned as leg 4's is, which the wide placement
   (``tables.cuckoo32_placement``) puts at 16,384 and 65,536 slots: two
   rounds at 16 Mi tokens and tombstone runs across tile edges, exactly,
   then each table's K3 and K4 round timed at 16 Mi tokens beside its
   bound, and K3 chained 8 times by graph replay at 65,536 slots;
4. main path: after one small run as set-up (it builds the native host
   library in a fresh checkout), ``blt_tpu_torch.cli.main(... --engine
   torch --type text)`` on a 1 GiB Zipf-text corpus in three legs (basic, BPE with the 500 most
   frequent pairs, BPE with 50k rules), each output's sha256 held against
   a NumPy reference written here, independent of both packages; the
   launch counters, set to 0 before each leg, must equal the number of
   batches (one fused K2 launch a BPE batch, and no launch of K2's three
   or of the pack); then each leg once more under ``torch.profiler`` for the
   device's busy time, idle share and time by kernel and copy;
5. general-table BPE through ``blt_tpu_torch.ByteTokenizer(merges=...,
   engine="torch", chunk_size="16MB").tokenize_file``: leg 4 on the 1 GiB
   corpus (K3 rounds, the default loop), leg 5 on its first 256 MiB under
   ``BLT_MP_COMPACT=sort`` (K4 rounds, each one look-back launch); each
   sha256 held against a NumPy multipass reference written here, run per
   16 MiB chunk on a process pool; the launches must equal the rounds the
   loop counted; each leg traced once more;
6. the CLI as a process, from a 64 MiB stdin pipe, byte for byte, and
   the seconds a fresh process takes to import the CLI and reach the card;
6b. shard: (a) ``run_tokenizer(config, engine=ShardedTorchEngine(devices=
   [cuda:0] * 4))`` on phases 4 and 5's five legs (bpe_500 on the whole
   corpus, the other four on its first 256 MiB, leg 5's input, each held to
   a reference of what it read), on a degenerate flat
   leg (64 MiB of the corpus with runs of one byte x across two slab
   boundaries and the rule (x, x): at least one batch must take the carry
   composition, and how many did is printed), then bpe_500 through
   ``cli.main(... --engine shard)`` (one row a card); (b) two processes of
   ``python3 -m blt_tpu_torch.cli --engine torch`` on this card, joined
   over gloo by ``BLT_COORDINATOR_ADDRESS`` / ``BLT_NUM_PROCESSES`` /
   ``BLT_PROCESS_ID``: bpe_500 and basic on the 1 GiB corpus, leg 4's
   table (through the API: a merges file holds only byte pairs) and the
   decode of the bpe_500 output, each process under a timeout. Every
   output's sha256 equals its leg's reference (decode: the input's); the
   launch counters, set to 0 before each leg, equal what the leg
   dispatched (K1 the rows, fused K2 the slabs, K3 / K4 the rounds); wall
   seconds, rows and processes are printed beside the one-row time;
6c. serve: ``blt_tpu_torch.server`` on the card. In process: the 500-pair
   table's server warmed to 16 MiB (one fused K2 a bucket) and a server
   without merges answer 1 KiB, 64 KiB, 1 MiB, 16 MiB and 64 MiB slices in
   BPE, basic and passthrough mode, an empty body and a /detokenize of the
   16 MiB reply; the 50k table at 64 MiB; leg 4's table at 16 MiB (K3
   rounds, then K4 rounds under ``BLT_MP_COMPACT=sort``, against
   ``multipass_reference``); eight clients sending 64 requests of 64 KiB to
   16 MiB at once (p50 / p99 latency by size, aggregate MB/s); ``engine
   auto`` at a 1 MiB threshold; ``engine shard``. Each body's sha256 equals
   its NumPy reference's, and the counters, set to 0 before each request
   (before the concurrent batch as a whole), give one fused K2 a non-empty
   BPE request, one K1 a basic one, none for passthrough, detokenize, an
   empty body and AUTO's requests below its threshold. The per-request
   costs (an encoder with its wire table, pinned staging, three stage
   threads) are timed alone. Then ``python -m blt_tpu_torch.server`` as a
   process with and without ``--warmup 16MB``: seconds to /health, a 1 MiB
   request's latency cold and warm; and one 64 MiB BPE leg of the CLI under
   ``BLT_PROFILE``, whose trace must name ``flat_packed_kernel``;
6d. train (``blt_tpu_torch.parallel.train``): (a) ``learn_bpe_sharded`` on
   the card, 500 rules, at 8 rows of the corpus's first 16 MiB, its table
   equal to a NumPy reference written here (``train_reference``: greedy
   count, the first index of the maximum, leftmost non-overlapping merges,
   rows apart); (b) ``learn_bpe``
   on the first 256 MiB, 500 rules, timed whole, its first 16 rules equal
   to the reference's; 20 of its rounds replayed with CUDA events between
   the steps (the count, the argmax and its host read, the match and scan,
   the compaction), each beside its bytes over 3.35 TB/s, and 20 under
   ``torch.profiler`` for the idle share, and the first round's count and
   scan beside ``torch.bincount`` and ``torch.cummax``; (c) ``python -m
   blt_tpu_torch.train_cli`` on the first 64 MiB, 8 rows, 500 rules with a
   checkpoint every 100, and a 250-rule run resumed to 500: the merges files
   byte-equal, the final checkpoints' arrays equal; (d) the 256 MiB table's
   merges file through ``cli.main(... --engine torch)`` (fused K2 launches
   equal to the batches, sha256 equal to ``flat_bpe_reference``'s) and the
   whole learned dict through ``ByteTokenizer.tokenize_file`` on 64 MiB (K3
   launches equal to the rounds, sha256 equal to ``multipass_reference``'s);
   the references run on a process pool during (c) and (d);
6e. fuzz: ``blt_tpu_torch.tools.fuzz_e2e`` on the card in process, 50
   trials of up to 200000 bytes (the three engines and the encoder legs at
   the trial's full size, each against the oracle) and 2 multi-process
   trials; the launches by kernel printed; then ``make_conformance``'s four
   goldens reproduced byte for byte by ``cli.main(... --engine torch)``;
7. measure, the device-rate path (``blt_tpu_torch.tools``): (a) K5, T1,
   T7, T8, T9, T5, T4 and T6 against their plain versions on the card,
   exactly (K5 and T1 chained 1 and 3 times from a nonzero token, T7 at
   rows_per_block 1, 8, 512, 2048 and 8192; the copy ring's ragged edges:
   T1's copy chained 1 and 3 times over one row, one stage + 128 B and 64
   MiB + 128 B, T7 over one grid step at each of those rpb and over three
   steps of one stage + 128 B; the T8 variants over every flat case of phase 3,
   ``full`` against K2; T9 on in-block, +-2 rpb and full-int32 indices at
   rows_per_block 8, 16, 1024, 2048 and 4096 (its slab path), 7240, 10000
   and 16384 (its direct path); T5 in
   int32, int16 and int8 over each type's whole range, chained 1 and 3
   times, and on ``exp_pack.edge_rows`` at 16384 x 128 chained 1, 3 and
   64 times; the five T4 variants over every token-pass case of phase 3,
   ``full`` against K4; the six T6 variants over every flat case of phase
   3, the two block-local ones at rows_per_block 8 and 1024, ``full``
   against K2; the four T2 variants over every flat case, each against its
   plain version and against K2 with its starts byteswapped; T10's ``prod``
   against K2, ``novalid`` and ``noscan2`` (rows_per_block 8, 16 and 1024)
   against their plain versions, and ``noscan2`` on the card tests' segment
   cases as T6's (n at the capacity, 3001 and 1, both carries, next_byte -1
   and 98, an all-match buffer, chains of 4 replayed from a CUDA graph);
   T12's two scans at rows_per_block 8, 24,
   1016 and 1024 on random masks of density 0, 0.3, 0.7 and 1, single
   links and chained 1 and 3 times, and a chain of 4 replayed from a CUDA
   graph; T13's five lookups on p inside and outside [0, 65536) over 16
   MiB and at 1000 and 4096 rows, once and chained 3 times, and each
   one's chain of 4 at 4096 rows replayed from a CUDA graph; T14 in int8
   and bf16 on the same two ranges at tiles 512, 48, 16 and 80 and at 133
   tiles of 512, once and chained 3 times;
   the eight 16-bit probes of T3 and T11 on the originals' x and on random
   |x| < 2**30 at 512, 8, 13, 513 and 131072 rows);
   (b) the launch counters set to 0, then the twelve ported tools' and
   ``exp_lookback``'s measurements in this process at the originals' sizes (K5, T1 and
   K2 chained 96 / 96 / 24 times, T7 at rows_per_block 512 / 2048 / 8192,
   the T8 variants chained 8 times and T9 8 times at 64 MiB (and at 16384
   rows per block, its direct path); T5 on 16384 x
   128 chained 64 times; T4 on 8 Mi tokens chained 8 times; T6 at 64 MiB
   chained 64 times; T2 and T10 at 64 MiB chained 8 times; T12 at 64 MiB
   chained 64 times; T13 and T14, with the original's three library rows,
   on 4096 and 131072 rows chained 16 times; T3 at 512 and 131072 rows and
   T11 at 8 rows, 16 launches each; ``exp_lookback``: K2 fused with its
   pack beside K2 then the pack at 64 MiB, and K4's look-back launch
   beside its three launches at 8 Mi tokens, chained 8 times, and K2's
   standalone pack over 16 Mi slots chained 8 times, the time the
   ``kernels`` line gives ``pack_slots``), each chain
   timed as launched and as a
   CUDA-graph replay (median and IQR of 5), beside its plain version, its
   bound (for T5 and T14 the larger of its bytes and its operations) and the
   one PyTorch call that computes the same function where there is one
   (``clone()``, ``torch.gather``, ``torch.take``,
   ``x[0::2].contiguous()``); the counters read (T4's and T6's ``full``, T2's
   ``base`` and T10's ``prod`` are K4, K2, T8's ``full`` and K2: their rows
   take those launches during their own tool's run; the three-launch K2,
   the pack and the three-launch K4, which the main path no longer runs,
   report the launches of this run);
   then the eight glue-only timing tools of the multipass loop, the engine
   and the 50k table at the originals' sizes, timed by the wall clock
   (median and IQR of MB/s beside the bytes bound) unless said otherwise:
   ``exp_multipass`` (a 9-rule hierarchical table, ``CudaTokenEncoder.encode``
   with host compaction at 16 MiB, the twin route ``bpe_torch.
   multipass_encode`` at 1 MiB), ``exp_mp`` (an 8-rule table at 4 MiB: host
   compaction, the sort loop with its transfers and without), ``exp_gap``
   (``gap_row`` again, then the gap loop with its wire, at rpb 512 and
   1024, and the sort loop at 8 MiB, 5 samples of 6 calls, and the host
   expansion of the wire), ``exp_gapvar`` (the gap loop's glue variants A-D
   and the port's own, round-robin at 8 MiB), ``exp_compact`` (one K4 round,
   ``sortkv``, ``sort1bit``, ``cumsum``, ``take``, ``scatter``, the port's
   ``_compact`` and the whole sort loop at 8 Mi tokens), ``exp_e2e``
   (file-to-file runs of 100 MiB through ``run_tokenizer`` at 64, 16 and 8
   MiB batches with their stage split, a 10 MiB run's phases, the bare
   upload and download), ``exp_dense`` (K2 fused with its pack on a
   50k-rule table at 64 MiB chained 8 times, as a graph replay) and
   ``exp_occ`` (the same on four tables of 50k to 9k rules over 256 to 48
   first bytes); each result held to the oracle, a NumPy result or the
   plain version (every output file's sha256 to the NumPy engine's);
   (c) ``python -m blt_tpu_torch.tools.<name>`` for each tool as a process,
   four at a time (``PROCESSES_AT_ONCE``),
   at most 8 MiB (``PROCESS_BYTES``; the row counts scaled to match;
   ``exp_e2e`` at batches of 4 and 2 MiB), each showing ``exact`` on a
   ``cuda`` device: (b) measured each at its original's size;
8. neither ``jax`` nor ``blt_tpu`` was ever imported.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the corpus, pair and bound recipes the device-rate tools use; the import
# fails where this script stands outside a checkout
from blt_tpu_torch.tools._common import (  # noqa: E402
    MIB,
    emit,
    frequent_pairs,
    make_corpus,
    nvidia_smi,
)
from blt_tpu_torch.tools._common import bound_ms as bytes_bound_ms  # noqa: E402
from blt_tpu_torch.tools import exp_gap, exp_lookback  # noqa: E402
from blt_tpu_torch.ops.tools_cuda import PROBES16  # noqa: E402


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# (label, source stem, a piece of the kernel's mangled name, its key in
# _cuda_build.CTAS_PER_SM): the main path's three one-launch look-back
# kernels, and the Hopper designs of T13's lookups (one template: g2d runs
# chain's instantiation), T6's scan16 and swarpack
# (T6's CTAs per SM at rpb 1024, swarpack's largest shared memory), T12's
# two mask scans, T3's and T11's eight probes (their CTAs per SM: the
# least of the eight), T10's noscan2 and T5's int16 and int8 mixes
LOOK_BACK_KERNELS = (("K3", "token_pass_gap", "tile_lookback", "token_pass_gap"),
                     ("K4", "token_pass", "tile_lookback", "token_pass"),
                     ("K2_packed", "flat_bpe", "flat_packed_kernel", "flat_bpe"))
REDESIGNED_TOOL_KERNELS = (*((f"lookup_{v}", "lookup", f"13lookup_kernelILi{i}E", f"lookup_{v}")
                             for i, v in ((0, "chain"), (2, "g2d_flat"), (3, "gax0"),
                                          (4, "g8bit"))),
                           ("noscan2", "scan_parts", "row_scan_kernel", "row_scan"),
                           ("scan16", "scan_parts", "segment_scanILb0E", "scan16"),
                           ("swarpack", "scan_parts", "segment_scanILb1E", "swarpack"),
                           ("mask_scan_i32", "scan_parts", "mask_scan_i32", "mask_scan_i32"),
                           ("mask_scan_bf16", "scan_parts", "mask_scan_bf16", "mask_scan_bf16"),
                           *((p, "probe16", f"probe16_kernelILi{i}E", "probe16")
                             for i, p in enumerate(PROBES16)),
                           ("op_mix_int16", "op_mix", "5Mix16", "op_mix16"),
                           ("op_mix_int8", "op_mix", "4Mix8", "op_mix8"))


def kernel_figures(kernels) -> dict:
    """ptxas's figures (registers, spills) for each kernel of ``kernels``,
    with the CTAs per SM the CUDA runtime's occupancy query gives for it."""
    from blt_tpu_torch.ops import _cuda_build

    out = {}
    for label, stem, match, key in kernels:
        found = {name: r for name, r in _cuda_build.kernel_resources(stem).items()
                 if match in name}
        if _cuda_build.build_seconds is not None and len(found) != 1:
            fail(f"ptxas reported {len(found)} kernels matching {match} in {stem}.cu")
        out[label] = {**next(iter(found.values()), {}),
                      "ctas_per_sm": _cuda_build.ctas_per_sm(key)}
    return out


def pallas_line(func: str, rel: str = "blt_tpu/ops/bpe_pallas.py") -> str:
    """``file:line`` of a function of the JAX side (the Pallas module, or a
    tool under ``tools/``), read as text: importing it would import JAX.
    ``outer.inner`` names a function defined inside another."""
    with open(os.path.join(ROOT, rel)) as f:
        lines = f.read().splitlines()

    def indent(line: str) -> int:
        return len(line) - len(line.lstrip())

    lo, hi, outer = 0, len(lines), -1
    for name in func.split("."):
        for i in range(lo, hi):
            if lines[i].lstrip().startswith(f"def {name}(") and (
                indent(lines[i]) > outer if outer >= 0 else indent(lines[i]) == 0
            ):
                outer, lo = indent(lines[i]), i + 1
                hi = next((j for j in range(lo, len(lines))
                           if lines[j].strip() and indent(lines[j]) <= outer), len(lines))
                break
        else:
            fail(f"{func} not found in {rel}")
    return f"{rel}:{lo}"


def fifty_k_pairs(rng, first):
    """``first`` then distinct random pairs, 50,000 in all."""
    pairs = list(first)
    seen = set(pairs)
    for code in rng.permutation(65536):
        if len(pairs) == 50_000:
            break
        p = (int(code) // 256, int(code) % 256)
        if p not in seen:
            seen.add(p)
            pairs.append(p)
    return pairs


def write_merges(path: str, pairs) -> None:
    with open(path, "w") as f:
        f.writelines(f"{a} {b}\n" for a, b in pairs)


def _counted_modules():
    """Every module that counts kernel launches."""
    from blt_tpu_torch.ops import bpe_cuda, multipass_cuda, tools_cuda

    return bpe_cuda, multipass_cuda, tools_cuda


def all_launches() -> dict:
    """Every kernel's launch count, by name."""
    return {k: v for m in _counted_modules() for k, v in m.launches.items()}


def reset_all_launches() -> None:
    for m in _counted_modules():
        m.reset_launches()


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of one call, by CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def int_err(a, b) -> int:
    """Max |a - b| over two integer tensors of one shape (0 when equal)."""
    import torch

    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(64 * MIB):
            h.update(block)
    return h.hexdigest()


def dense_of(merges):
    """int32[65536] rule value by byte pair ``a * 256 + b``, -1 for no rule
    (the layout ``blt_tpu_torch.ops.tables.wire_table`` takes)."""
    import numpy as np

    dense = np.full(65536, -1, np.int32)
    for (a, b), v in merges.items():
        dense[a * 256 + b] = v
    return dense


def numbered(pairs):
    """Merges-file lines in order -> rules: line i makes token 256 + i."""
    return {p: 256 + i for i, p in enumerate(pairs)}


def flat_bpe_reference(data, dense, chunk: int = 16 * MIB):
    """One flat-BPE pass over ``data`` as u16-BE bytes, in pieces: merge
    byte pair (i, i+1) when it has a rule and the run of rule pairs it
    ends began an odd number of positions back (leftmost non-overlapping
    merges), drop the byte a merge consumed, widen every other byte."""
    import numpy as np

    n = data.shape[0]
    last_nonmatch, carry = -1, False
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = data[s:e].astype(np.int32)
        nxt = np.empty_like(d)
        nxt[:-1] = d[1:]
        nxt[-1] = data[e] if e < n else 0
        val = dense[d * 256 + nxt]
        if e == n:
            val[-1] = -1  # the last byte has no pair
        m = val >= 0
        idx = np.arange(s, e, dtype=np.int32)
        lz = np.maximum.accumulate(np.where(m, last_nonmatch, idx))
        start = m & (((idx - lz) & 1) == 1)
        consumed = np.empty_like(start)
        consumed[0] = carry
        consumed[1:] = start[:-1]
        yield np.where(start, val, d)[~consumed].astype(">u2").tobytes()
        last_nonmatch, carry = int(lz[-1]), bool(start[-1])


def reference_sha(data, dense, header: bytes) -> str:
    """sha256 of ``header`` + the reference output: basic widen when
    ``dense`` is None, else one flat-BPE pass."""
    h = hashlib.sha256(header)
    if dense is None:
        for s in range(0, data.shape[0], 64 * MIB):
            h.update(data[s : s + 64 * MIB].astype(">u2").tobytes())
    else:
        for piece in flat_bpe_reference(data, dense):
            h.update(piece)
    return h.hexdigest()


def multipass_reference(data, keys, vals):
    """General-table BPE of one chunk: merge passes until one merges
    nothing. In a pass the pair (t[i], t[i+1]) merges when the table has a
    rule for it and the run of rule pairs it ends began an odd number of
    positions back (leftmost non-overlapping merges); the pair's second
    token is dropped. ``keys``: sorted int64 ``a << 16 | b``; ``vals``:
    int64 rule values in the same order. Returns int64 tokens."""
    import numpy as np

    t = np.asarray(data, dtype=np.int64)
    while t.shape[0] >= 2:
        k = (t[:-1] << 16) | t[1:]
        pos = np.minimum(np.searchsorted(keys, k), keys.shape[0] - 1)
        match = keys[pos] == k
        if not match.any():
            break
        idx = np.arange(k.shape[0])
        last_nonmatch = np.maximum.accumulate(np.where(match, -1, idx))
        start = match & (((idx - last_nonmatch) & 1) == 1)
        out = t.copy()
        out[:-1] = np.where(start, vals[pos], t[:-1])
        keep = np.ones(t.shape[0], bool)
        keep[1:] = ~start
        t = out[keep]
    return t


def _reference_chunk(args) -> bytes:
    data, keys, vals = args
    return multipass_reference(data, keys, vals).astype(">u2").tobytes()


def rule_arrays(rules):
    """Rules -> (sorted int64 keys ``a << 16 | b``, int64 values)."""
    import numpy as np

    items = sorted(((a << 16) | b, v) for (a, b), v in rules.items())
    return (np.array([k for k, _ in items], np.int64),
            np.array([v for _, v in items], np.int64))


def reference_multipass_shas(corpus, rules, chunk: int, first: int):
    """sha256 of the per-chunk multipass reference over the whole corpus,
    and over its first ``first`` chunks, on a process pool (general-table
    chunks are independent)."""
    import concurrent.futures
    import multiprocessing

    keys, vals = rule_arrays(rules)
    h_all, h_first = hashlib.sha256(), hashlib.sha256()
    jobs = ((corpus[s : s + chunk], keys, vals) for s in range(0, corpus.shape[0], chunk))
    with concurrent.futures.ProcessPoolExecutor(
        os.cpu_count(), mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        for j, piece in enumerate(pool.map(_reference_chunk, jobs)):
            h_all.update(piece)
            if j < first:
                h_first.update(piece)
    return h_all.hexdigest(), h_first.hexdigest()


def bound_ms(*tensors) -> float:
    """Least time for a function that reads its inputs and writes its
    outputs once each: their bytes over the card's memory rate."""
    return bytes_bound_ms(sum(t.numel() * t.element_size() for t in tensors))


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity). Returns
    wall seconds, device busy seconds (union of kernel and copy
    intervals), the idle share, and device ms by kernel or copy name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    if not events:
        fail("the profiler saw no device activity")
    by_name = {}
    for e in events:
        key = e.name[:48]
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return {
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "idle_share": 1 - busy_us / 1e6 / wall,
        "device_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
    }


def phase_kernels(corpus, merges500, merges50k, rng):
    """Phase 3: every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from blt_tpu_torch.ops import bpe_cuda
    from blt_tpu_torch.ops.tables import wire_table
    from blt_tpu_torch.tools.exp_chain import widen_call

    dev = torch.device("cuda", 0)

    def table_of(merges):
        return wire_table(dense_of(merges), dev)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    err = {"widen": 0, "flat_bpe": 0, "pack_slots": 0, "flat_bpe_packed": 0}
    cases = 0
    flat_cases = []  # (data, n, next_byte, table, carry): phase 7 replays them

    def check_flat(data, n, nb, table, carry, prev):
        """K2, the pack, and the two fused into one launch, each against its
        plain version."""
        nonlocal cases
        flat_cases.append((data, n, nb, table, carry))
        c_in = torch.tensor([[carry]], dtype=torch.int32, device=dev)
        p_in = torch.tensor(prev, dtype=torch.int32, device=dev)
        slots, c_out = bpe_cuda.flat_encode_slots(data, n, nb, table, c_in)
        ref_slots, ref_c = bpe_cuda.flat_pass_plain(data, n, nb, table, c_in)
        wire, last = bpe_cuda.pack_slots(slots, n, p_in)
        ref_wire, ref_last = bpe_cuda.pack_slots_plain(ref_slots, n, p_in)
        fused = bpe_cuda.flat_encode_packed(data, n, nb, table, c_in, p_in)
        ref_fused = bpe_cuda.flat_packed_plain(data, n, nb, table, c_in, p_in)
        torch.cuda.synchronize()
        e_flat = max(int_err(slots, ref_slots), int_err(c_out, ref_c))
        e_pack = max(int_err(wire, ref_wire), int_err(last, ref_last))
        e_fused = max(int_err(a, b) for a, b in zip(fused, ref_fused, strict=True))
        if e_flat or e_pack or e_fused:
            fail(f"flat pass n={n} next_byte={nb} carry={carry} prev_slot={prev:#x}: "
                 f"slot/carry err {e_flat}, wire/last err {e_pack}, fused err {e_fused}")
        err["flat_bpe"] = max(err["flat_bpe"], e_flat)
        err["pack_slots"] = max(err["pack_slots"], e_pack)
        err["flat_bpe_packed"] = max(err["flat_bpe_packed"], e_fused)
        cases += 1
        return wire, c_out, last

    t500 = table_of(merges500)
    t50k = table_of(merges50k)
    big = on_dev(corpus[: 16 * MIB])

    # widen: small, 16 MiB, a ragged length, one byte
    for n in (64 * 1024, 16 * MIB, 16 * MIB + 5, 1):
        x = on_dev(corpus[:n])
        e = int_err(bpe_cuda.basic_encode(x), bpe_cuda.widen_plain(x))
        torch.cuda.synchronize()
        if e:
            fail(f"widen n={n}: err {e}")
        cases += 1

    # 64 KiB and 16 MiB batches of text, 500 and 50k rules
    small = on_dev(corpus[: 64 * 1024])
    check_flat(small, 64 * 1024, int(corpus[64 * 1024]), t500, 0, 0)
    check_flat(big, 16 * MIB, -1, t500, 0, 0)
    check_flat(big, 16 * MIB, int(corpus[16 * MIB]), t50k, 1, 0x6568)
    # an all-match run over ~1000 tiles, both carries, odd length
    run = on_dev(np.full(4 * MIB, 97, np.uint8))
    t_aa = table_of({(97, 97): 256})
    for carry in (0, 1):
        for nb in (97, -1):
            check_flat(run, 4 * MIB - 3, nb, t_aa, carry, 0)
    # next_byte -1, 0 and 255 with rules that pair the last byte with them
    raw = rng.integers(0, 256, 64 * 1024).astype(np.uint8)
    n = raw.shape[0] - 1000
    last = int(raw[n - 1])
    pairs = {(int(a), int(b)) for a, b in rng.integers(0, 256, (300, 2))}
    pairs |= {(last, 0), (last, 255)}
    t_nb = table_of({p: 256 + i for i, p in enumerate(sorted(pairs))})
    for nb in (-1, 0, 255):
        for carry in (0, 1):
            check_flat(on_dev(raw), n, nb, t_nb, carry, 0)
    # the (255,255) rule present and absent, over runs of 0xFF
    ff = rng.choice(np.array([255, 255, 255, 97], np.uint8), 64 * 1024)
    for merges in ({(255, 255): 0xFFFF, (97, 255): 256}, {(97, 255): 256}):
        check_flat(on_dev(ff), ff.shape[0], -1, table_of(merges), 0, 0)
    # a stale tail of matching bytes past n, and n = 1, and n = 0
    check_flat(small, 40_000, int(corpus[40_000]), t500, 0, 0)
    check_flat(small, 40_000, -1, t_aa, 1, 0)
    for nb in (-1, int(corpus[1])):
        for carry in (0, 1):
            check_flat(small, 1, nb, t500, carry, 0)
    check_flat(small, 0, -1, t500, 1, 0x6100)
    # the fused pass's edges: lengths 0 to one past a tile, carry 1, a
    # prev_slot that is a merge start (low byte nonzero), and a merge
    # starting on the last position of every tile ((x, 97) has no rule in
    # t_aa, (97, 97) has)
    edges = rng.integers(98, 123, 64 * 1024).astype(np.uint8)
    for e in range(4096, edges.shape[0], 4096):
        edges[e - 1 : e + 1] = 97
    for n in (0, 1, 7, 8, 4095, 4096, 4097, edges.shape[0]):
        for carry, nb, prev in ((0, -1, 0), (1, 97, 0x0161)):
            check_flat(on_dev(edges), n, nb, t_aa, carry, prev)

    # four 16 MiB batches chained through carry and prev_slot, kernel chains
    # (K2 then the pack, and the fused pass) against the plain chain
    carry_k = carry_p = carry_f = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    prev_k = prev_p = prev_f = torch.zeros((), dtype=torch.int32, device=dev)
    for j in range(4):
        piece = on_dev(corpus[j * 16 * MIB : (j + 1) * 16 * MIB])
        nb = int(corpus[(j + 1) * 16 * MIB]) if j < 3 else -1
        slots, carry_k = bpe_cuda.flat_encode_slots(piece, 16 * MIB, nb, t500, carry_k)
        wire_k, prev_k = bpe_cuda.pack_slots(slots, 16 * MIB, prev_k)
        wire_f, carry_f, prev_f = bpe_cuda.flat_encode_packed(piece, 16 * MIB, nb, t500,
                                                              carry_f, prev_f)
        s_p, carry_p = bpe_cuda.flat_pass_plain(piece, 16 * MIB, nb, t500, carry_p)
        wire_p, prev_p = bpe_cuda.pack_slots_plain(s_p, 16 * MIB, prev_p)
        torch.cuda.synchronize()
        e = max(int_err(wire_k, wire_p), int_err(carry_k, carry_p), int_err(prev_k, prev_p))
        e_f = max(int_err(wire_f, wire_p), int_err(carry_f, carry_p), int_err(prev_f, prev_p))
        if e or e_f:
            fail(f"chained batch {j}: err {e}, fused err {e_f}")
        cases += 1

    # times at 16 MiB: kernel and plain on the same tensors
    c0 = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    p0 = torch.zeros((), dtype=torch.int32, device=dev)
    slots, c1 = bpe_cuda.flat_encode_slots(big, 16 * MIB, -1, t500, c0)
    wire, last = bpe_cuda.pack_slots(slots, 16 * MIB, p0)
    bounds = {
        "widen": bound_ms(big, bpe_cuda.basic_encode(big)),
        "flat_bpe": bound_ms(big, t500, c0, slots, c1),
        "pack_slots": bound_ms(slots, p0, wire, last),
        # the bytes in and the wire out, no slots: 2.125 bytes a position
        "flat_bpe_packed": bound_ms(big, t500, c0, p0, wire, c1, last),
    }
    ms = {
        "widen": (
            cuda_ms(lambda: bpe_cuda.basic_encode(big)),
            cuda_ms(lambda: bpe_cuda.widen_plain(big)),
        ),
        "flat_bpe": (
            cuda_ms(lambda: bpe_cuda.flat_encode_slots(big, 16 * MIB, -1, t500, c0)),
            cuda_ms(lambda: bpe_cuda.flat_pass_plain(big, 16 * MIB, -1, t500, c0)),
        ),
        "pack_slots": (
            cuda_ms(lambda: bpe_cuda.pack_slots(slots, 16 * MIB, p0)),
            cuda_ms(lambda: bpe_cuda.pack_slots_plain(slots, 16 * MIB, p0)),
        ),
        "flat_bpe_packed": (
            cuda_ms(lambda: bpe_cuda.flat_encode_packed(big, 16 * MIB, -1, t500, c0, p0)),
            cuda_ms(lambda: bpe_cuda.flat_packed_plain(big, 16 * MIB, -1, t500, c0, p0)),
        ),
    }
    # the one PyTorch call of K1's function, held equal to the kernel's output
    if int_err(widen_call(big), bpe_cuda.basic_encode(big)):
        fail("the widen's single PyTorch call differs from K1")
    library = {"widen": cuda_ms(lambda: widen_call(big))}
    extra = {
        "flat_bpe_50k_ms": cuda_ms(
            lambda: bpe_cuda.flat_encode_slots(big, 16 * MIB, -1, t50k, c0)
        ),
        "d2d_copy_16mib_ms": cuda_ms(lambda: big.clone()),
        # the design the fused pass replaces, one call of it in the same run
        "flat_bpe_then_pack_ms": cuda_ms(lambda: bpe_cuda.pack_slots(
            bpe_cuda.flat_encode_slots(big, 16 * MIB, -1, t500, c0)[0], 16 * MIB, p0)),
    }
    emit({
        "phase": "kernels", "cases": cases, "tolerance": 0,
        "max_abs_err": err,
        "ms_16mib": {k: {"kernel": v[0], "plain": v[1], "bound": bounds[k],
                         "library": library.get(k)}
                     for k, v in ms.items()},
        **extra,
    })
    return err, ms, bounds, flat_cases, library


def phase_multipass_kernels(corpus, rules, rng):
    """Phase 3, general tables: K3 and K4 against their plain versions on
    the card, exactly, then times at a 16 Mi-token capacity."""
    import numpy as np
    import torch

    from blt_tpu_torch.merges import MergeTable
    from blt_tpu_torch.ops import multipass_cuda as mc
    from blt_tpu_torch.ops.tables import cuckoo_planes

    dev = torch.device("cuda", 0)

    def planes_of(merges):
        planes = cuckoo_planes(MergeTable.build(merges), dev)
        if planes is None:
            fail(f"cuckoo32 cannot place a {len(merges)}-rule table")
        return planes

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    err = {"token_pass_gap": 0, "token_pass": 0, "token_pass_lookback": 0}
    cases = 0
    token_cases = []  # (tokens, n, planes): phase 7 replays them

    def check(toks, n, planes, what, gap=None):
        """K4 on toks[:n] (the look-back round and the three launches), and
        K3 on ``gap`` (default: toks with -1 past n); returns K3's output,
        to chain rounds."""
        nonlocal cases
        t = on_dev(toks)
        token_cases.append((t, n, planes))
        if gap is None:
            gap = np.array(toks, np.int32)
            gap[n:] = -1
        g = on_dev(gap)
        ref4 = mc.token_pass_plain(t, n, planes)
        e4 = int_err(mc.token_pass(t, n, planes, mc.TOKEN_PASSES["token_pass"]), ref4)
        e4l = int_err(mc.token_pass(t, n, planes, mc.K4_FLAGS), ref4)
        out, count = mc.token_pass_gap(g, planes)
        ref, ref_count = mc.token_pass_gap_plain(g, planes)
        torch.cuda.synchronize()
        e3 = max(int_err(out, ref), int_err(count, ref_count))
        if e3 or e4 or e4l:
            fail(f"token passes, {what} (n={n}): K3 err {e3}, K4 err {e4l}, "
                 f"three-launch K4 err {e4}")
        err["token_pass_gap"] = max(err["token_pass_gap"], e3)
        err["token_pass"] = max(err["token_pass"], e4)
        err["token_pass_lookback"] = max(err["token_pass_lookback"], e4l)
        cases += 1
        return out.cpu().numpy()

    chain = planes_of({(97, 97): 256, (256, 256): 257, (257, 257): 258, (258, 258): 259})
    high = planes_of({(0xFFFF, 97): 40000, (40000, 0xFFFF): 0xFFFF, (97, 0xFFFF): 32768,
                      (32768, 32768): 50000, (0xFFFF, 0xFFFF): 0xFFFE})
    table8k = planes_of(rules)
    if table8k.slots != 8192:
        fail(f"the 8000-rule table placed at {table8k.slots} slots, not 8192")

    # empty, one and two tokens
    a = np.full(4096, 97, np.int32)
    for n in (0, 1, 2):
        check(a, n, chain, "short")
    # lengths 0 to one past a tile, and a merge starting on the last
    # position of tiles 0 and 1 ((120, 97) has no rule, (97, 97) has)
    edges = rng.choice(np.array([98, 99, 120], np.int32), 3 * 4096 + 128)
    for e in (4096, 8192):
        edges[e - 2 : e + 1] = [120, 97, 97]
    for n in (0, 1, 7, 8, 4095, 4096, 4097, 8193, edges.shape[0]):
        check(edges, n, chain, "tile edges")
    # a hierarchical chain over tile edges, four rounds fed back through K3
    gap = np.full(3 * 4096 + 128, 97, np.int32)
    for _ in range(4):
        gap = check(gap, gap.shape[0], chain, "chain round", gap=gap)
    # tokens >= 32768 with 0xFFFF: the int32 wrap of the key and the hash
    hi = rng.choice(np.array([97, 0xFFFF, 32768, 40000], np.int32), 64 * 1024)
    check(hi, hi.shape[0], high, "high tokens")
    check(hi, 40_001, high, "high tokens, stale tail")
    # the 8192-slot table on the corpus at the main path's shape, two rounds
    cap = 16 * MIB
    toks = corpus[:cap].astype(np.int32)
    round1 = check(toks, cap, table8k, "8192 slots")
    check(round1, cap, table8k, "8192 slots, round 2", gap=round1)
    # runs of 1 to 5 tombstones across a tile edge, in a tombstoned round
    for run in range(1, 6):
        g = round1[: 64 * 1024].copy()
        for edge in range(4096, g.shape[0], 4096):
            start = edge - (run + 1) // 2
            g[start : start + run] = -1
        check(g, g.shape[0], table8k, f"tombstone runs of {run}", gap=g)

    # the wide placement: tables learned as leg 4's is, past the default
    # 8192 slots, at the main path's shape, two rounds, then tombstone runs
    wide = {}
    for n_rounds, per_round, slots in ((18, 500, 16384), (25, 2000, 65536)):
        planes = planes_of(exp_gap.hierarchical_rules(corpus, n_rounds, per_round))
        if planes.slots != slots:
            fail(f"the {n_rounds * per_round}-rule table placed at {planes.slots} "
                 f"slots, not {slots}")
        w1 = check(toks, cap, planes, f"{slots} slots")
        check(w1, cap, planes, f"{slots} slots, round 2", gap=w1)
        g = w1[: 64 * 1024].copy()
        for edge in range(4096, g.shape[0], 4096):
            g[edge - 2 : edge + 1] = -1
        check(g, g.shape[0], planes, f"{slots} slots, tombstone runs of 3", gap=g)
        wide[slots] = planes

    # times at a 16 Mi-token capacity: the first round of leg 4's table
    t = on_dev(toks)
    g_out, g_count = mc.token_pass_gap(t, table8k)
    k_out = mc.token_pass(t, cap, table8k)
    planes = (table8k.k1, table8k.v1, table8k.k2, table8k.v2)
    bounds = {
        "token_pass_gap": bound_ms(t, *planes, g_out, g_count),
        "token_pass": bound_ms(t, *planes, k_out),
        "token_pass_lookback": bound_ms(t, *planes, k_out),
    }
    k4_plain_ms = cuda_ms(lambda: mc.token_pass_plain(t, cap, table8k))
    three = mc.TOKEN_PASSES["token_pass"]  # the design the look-back replaced
    ms = {
        "token_pass_gap": (cuda_ms(lambda: mc.token_pass_gap(t, table8k)),
                           cuda_ms(lambda: mc.token_pass_gap_plain(t, table8k))),
        "token_pass": (cuda_ms(lambda: mc.token_pass(t, cap, table8k, three)), k4_plain_ms),
        "token_pass_lookback": (cuda_ms(lambda: mc.token_pass(t, cap, table8k, mc.K4_FLAGS)),
                                k4_plain_ms),
    }

    # what the loop's one host read per round costs: 8 chained K3 rounds
    # with and without reading the count after each
    def rounds(read: bool):
        b = t
        for _ in range(8):
            b, c = mc.token_pass_gap(b, table8k)
            if read:
                int(c)

    host_read_ms = (cuda_ms(lambda: rounds(True)) - cuda_ms(lambda: rounds(False))) / 8
    # K3 chained 8 times through its own output, replayed from a CUDA graph
    chained = exp_gap.gap_row(t, table8k)
    if not chained["exact"]:
        fail("K3 chained 8 times differs from its plain chain")
    # K4 chained 8 times the same way, its look-back launch beside its three
    k4_chained = exp_lookback.k4_rows(t, cap, table8k)
    if not all(r["exact"] for r in k4_chained):
        fail("K4 chained 8 times differs from its plain chain")
    # the wide tables' first rounds at 16 Mi tokens, K3 chained at 65,536
    wide_ms = {}
    for slots, planes in wide.items():
        g_out, g_count = mc.token_pass_gap(t, planes)
        k_out = mc.token_pass(t, cap, planes)
        p4 = (planes.k1, planes.v1, planes.k2, planes.v2)
        wide_ms[slots] = {
            "token_pass_gap": {"kernel": cuda_ms(lambda: mc.token_pass_gap(t, planes)),
                               "bound": bound_ms(t, *p4, g_out, g_count)},
            "token_pass_lookback": {
                "kernel": cuda_ms(lambda: mc.token_pass(t, cap, planes, mc.K4_FLAGS)),
                "bound": bound_ms(t, *p4, k_out)},
        }
    wide_chained = exp_gap.gap_row(t, wide[65536])
    if not wide_chained["exact"]:
        fail("K3 chained 8 times at 65,536 slots differs from its plain chain")
    emit({
        "phase": "multipass_kernels", "cases": cases, "tolerance": 0,
        "max_abs_err": err, "slots": table8k.slots,
        "ms_16mi_tokens": {k: {"kernel": v[0], "plain": v[1], "bound": bounds[k]}
                           for k, v in ms.items()},
        "token_pass_gap_chained_8": {
            "graph_ms": chained["graph"]["ms_per_launch"]["median"],
            "graph_iqr_ms": chained["graph"]["ms_per_launch"]["iqr"],
            "eager_ms": chained["eager"]["ms_per_launch"]["median"],
            "bound_ms": chained["bound_ms"]},
        "token_pass_chained_8": {
            r["name"]: {"graph_ms": r["graph"]["ms_per_launch"]["median"],
                        "graph_iqr_ms": r["graph"]["ms_per_launch"]["iqr"],
                        "eager_ms": r["eager"]["ms_per_launch"]["median"],
                        "bound_ms": r["bound_ms"]} for r in k4_chained},
        "host_read_ms_per_round": host_read_ms,
        "wide_ms_16mi_tokens": wide_ms,
        "token_pass_gap_chained_8_at_65536_slots": {
            "graph_ms": wide_chained["graph"]["ms_per_launch"]["median"],
            "graph_iqr_ms": wide_chained["graph"]["ms_per_launch"]["iqr"],
            "eager_ms": wide_chained["eager"]["ms_per_launch"]["median"],
            "bound_ms": wide_chained["bound_ms"]},
    })
    return err, ms, bounds, token_cases


def phase_main_path(corpus, merges500, merges50k, workdir):
    """Phase 4: the CLI in process on the full corpus, three legs, each
    checked, then each traced once."""
    from blt_tpu_torch import cli
    from blt_tpu_torch.pipeline.feeder import stage_stats
    from blt_tpu_torch.pipeline.runner import _device_batch_bytes, _plan_feed_size

    size = corpus.shape[0]
    inp = os.path.join(workdir, "corpus.bin")
    t0 = time.perf_counter()
    corpus.tofile(inp)
    m500 = os.path.join(workdir, "merges_500.txt")
    m50k = os.path.join(workdir, "merges_50k.txt")
    write_merges(m500, merges500)
    write_merges(m50k, merges50k)
    t1 = time.perf_counter()
    # A first small run builds the port's native host library (g++, at
    # first use, in a fresh checkout), which the engine's pack and drain
    # stages load; that build is set-up, not part of the first leg.
    from blt_tpu_torch.native.build import library_path

    host_lib = library_path()
    prebuilt = os.path.exists(host_lib)
    small = os.path.join(workdir, "small.bin")
    corpus[: 64 * 1024].tofile(small)
    t2 = time.perf_counter()
    if cli.main(["-i", small, "-o", small + ".out", "--engine", "torch"]) != 0:
        fail("the first small run failed")
    emit({"phase": "setup", "input_bytes": size, "write_s": t1 - t0,
          "host_lib_in_checkout": prebuilt,
          "host_lib_built": os.path.exists(host_lib),
          "first_run_s": time.perf_counter() - t2})
    chunk = 16 * MIB
    batches = -(-size // _plan_feed_size(chunk, _device_batch_bytes()))
    header = (0xFF01).to_bytes(2, "big")  # the text content-type token

    legs = [("basic", None, None, "widen"),
            ("bpe_500", m500, merges500, "flat_bpe_packed"),
            ("bpe_50k", m50k, merges50k, "flat_bpe_packed")]

    def out_of(name):
        return os.path.join(workdir, f"out_{name}.bin")

    def run_leg(name, merges):
        argv = ["-i", inp, "-o", out_of(name), "--engine", "torch",
                "--type", "text", "--chunksize", "16MB"]
        rc = cli.main(argv + (["--merges", merges] if merges else []))
        if rc != 0:
            fail(f"leg {name}: cli.main returned {rc}")

    totals = {k: 0 for k in all_launches()}
    checked = {}  # leg -> its merges file, reference sha256 and seconds
    for name, merges, pairs, kernel in legs:
        out = out_of(name)
        reset_all_launches()  # the counts of this leg alone
        stage_stats(reset=True)
        t0 = time.perf_counter()
        run_leg(name, merges)
        seconds = time.perf_counter() - t0
        stages = stage_stats(reset=True)
        got = all_launches()
        # one fused launch a batch: K2's three and the pack's one no more
        if got[kernel] != batches or got["flat_bpe"] or got["pack_slots"]:
            fail(f"leg {name}: launches {got}, expected {batches} batches")
        for k, v in got.items():
            totals[k] += v
        sha = sha256_file(out)
        out_bytes = os.path.getsize(out)
        os.unlink(out)
        t1 = time.perf_counter()
        ref = reference_sha(corpus, dense_of(numbered(pairs)) if pairs else None, header)
        ref_seconds = time.perf_counter() - t1
        if sha != ref:
            fail(f"leg {name}: sha256 {sha} != reference {ref}")
        checked[name] = {"merges": merges, "sha256": ref, "seconds": seconds}
        emit({
            "phase": "main_path", "leg": name, "input_bytes": size,
            "output_bytes": out_bytes, "batches": batches, "launches": got,
            "seconds": seconds, "MB_per_s": size / seconds / 1e6,
            "sha256": sha, "reference_sha256": ref,
            "reference_seconds": ref_seconds,
            # per pipeline stage: seconds producing, blocked handing on, and
            # the consumer's seconds waiting for it
            "stages": {k: {m: round(v, 4) for m, v in st.items()}
                       for k, st in stages.items()},
        })
    if not all(totals[k] for k in ("widen", "flat_bpe_packed")):
        fail(f"a kernel of the path was never launched: {totals}")

    # where the time goes: each leg once more, traced (counts already read)
    for name, merges, _, _ in legs:
        trace = device_profile(functools.partial(run_leg, name, merges))
        os.unlink(out_of(name))
        emit({"phase": "trace", "leg": name, **trace})
    return inp, m500, totals, checked


def phase_multipass(corpus, inp, rules, workdir, chunk: int = 16 * MIB,
                    head_bytes: int = 256 * MIB):
    """Phase 5: general-table BPE through the API in ``chunk``-byte chunks.
    Leg 4: the whole corpus, default loop (K3). Leg 5: its first
    ``head_bytes`` under ``BLT_MP_COMPACT=sort`` (K4). Each checked against
    the NumPy multipass reference, then traced once more."""
    import blt_tpu_torch
    from blt_tpu_torch.ops import multipass_cuda
    from blt_tpu_torch.pipeline.feeder import stage_stats

    part = os.path.join(workdir, "corpus_head.bin")
    head = corpus[:head_bytes]
    head.tofile(part)
    out = os.path.join(workdir, "out_multipass.bin")
    legs = [("multipass_gap", inp, corpus.shape[0], "gap", "token_pass_gap"),
            ("multipass_sort", part, head.shape[0], "sort", "token_pass_lookback")]

    def run_leg(src, mode):
        os.environ["BLT_MP_COMPACT"] = mode
        try:
            tok = blt_tpu_torch.ByteTokenizer(merges=rules, engine="torch",
                                              chunk_size=f"{chunk // 1024}KB")
            tok.tokenize_file(src, out)
        finally:
            del os.environ["BLT_MP_COMPACT"]

    results, totals, seconds_of = {}, {}, {}
    for name, src, size, mode, kernel in legs:
        reset_all_launches()  # the counts of this leg alone
        stage_stats(reset=True)
        t0 = time.perf_counter()
        run_leg(src, mode)
        seconds = time.perf_counter() - t0
        stages = stage_stats(reset=True)
        got = all_launches()
        loops = list(multipass_cuda.loop_log)
        rounds = [r for r, _ in loops]
        chunks = -(-size // chunk)
        # the sort loop's rounds are the look-back K4, never the three launches
        if (len(loops) != chunks or got[kernel] != sum(rounds) or not got[kernel]
                or got["token_pass"]):
            fail(f"leg {name}: launches {got}, {len(loops)} loops of {sum(rounds)} "
                 f"rounds, expected {chunks} chunks")
        totals[kernel] = got[kernel]
        seconds_of[name] = seconds
        results[name] = (sha256_file(out), os.path.getsize(out))
        os.unlink(out)
        emit({
            "phase": "multipass", "leg": name, "compact": mode, "input_bytes": size,
            "output_bytes": results[name][1], "chunks": chunks, "launches": got,
            "rounds_per_chunk": {"min": min(rounds), "max": max(rounds),
                                 "mean": sum(rounds) / len(rounds)},
            "compactions_per_chunk": sum(c for _, c in loops) / len(loops),
            "host_reads": sum(rounds),  # one 4-byte read of the count per round
            "seconds": seconds, "MB_per_s": size / seconds / 1e6,
            "sha256": results[name][0],
            "stages": {k: {m: round(v, 4) for m, v in st.items()}
                       for k, st in stages.items()},
        })

    # the reference, per chunk on a process pool, after the timed legs
    t0 = time.perf_counter()
    ref_all, ref_head = reference_multipass_shas(corpus, rules, chunk, -(-head_bytes // chunk))
    ref_seconds = time.perf_counter() - t0
    for name, ref in (("multipass_gap", ref_all), ("multipass_sort", ref_head)):
        if results[name][0] != ref:
            fail(f"leg {name}: sha256 {results[name][0]} != reference {ref}")
    emit({"phase": "multipass_reference", "equal": True, "seconds": ref_seconds,
          "processes": os.cpu_count(), "sha256": {"multipass_gap": ref_all,
                                                  "multipass_sort": ref_head}})

    for name, src, _, mode, _ in legs:
        trace = device_profile(functools.partial(run_leg, src, mode))
        os.unlink(out)
        emit({"phase": "trace", "leg": name, **trace})
    checked = {"multipass_gap": {"src": inp, "sha256": ref_all},
               "multipass_sort": {"src": part, "sha256": ref_head}}
    for name in checked:
        checked[name]["seconds"] = seconds_of[name]
    return totals, checked


def phase_process(inp, m500, merges500):
    """Phase 6: the CLI module as a process, 64 MiB through a stdin pipe,
    and what a fresh process spends before its first batch."""
    import numpy as np

    data = np.fromfile(inp, dtype=np.uint8, count=64 * MIB)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "blt_tpu_torch.cli", "--engine", "torch",
         "--merges", m500],
        input=data.tobytes(), capture_output=True, env=env, cwd=ROOT,
        timeout=600,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli process exited {proc.returncode}: {proc.stderr.decode()[-2000:]}")
    ref = b"".join(flat_bpe_reference(data, dense_of(numbered(merges500))))
    if proc.stdout != ref:
        fail(f"cli process output ({len(proc.stdout)} bytes) != reference "
             f"({len(ref)} bytes)")
    # a fresh process: seconds to import the CLI, then to bring up the card
    probe = (
        "import json, time; t0 = time.perf_counter(); import blt_tpu_torch.cli; "
        "t1 = time.perf_counter(); import torch; torch.zeros(1, device='cuda'); "
        "torch.cuda.synchronize(); t2 = time.perf_counter(); "
        "print(json.dumps({'import_cli_s': t1 - t0, 'cuda_init_s': t2 - t1}))"
    )
    t1 = time.perf_counter()
    startup = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300, check=True,
    )
    startup = {**json.loads(startup.stdout.strip().splitlines()[-1]),
               "process_s": time.perf_counter() - t1}
    emit({"phase": "process", "input_bytes": int(data.shape[0]),
          "output_bytes": len(proc.stdout), "seconds": seconds, "equal": True,
          "fresh_process": startup})


# the byte the degenerate leg lays in runs across slab boundaries: absent
# from the corpus's alphabet, its only rule is (x, x)
DEGENERATE_BYTE = 1


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# a rank of a two-process leg: runs ``cli.main(args)`` ("cli") or leg 4's
# tokenize_file through the API ("api": rules JSON, input, output, chunk
# size), then writes ``<report>.<rank>.json``: the rank's launches, its
# loops, the bounds its runner planned and whether it ran a distributed
# decode. Both spies wrap the runner's own functions and change nothing.
RANK_WRAPPER = """
import json, os, sys
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda
from blt_tpu_torch.parallel import multihost

planned, decoded = [], []
plan, decode = multihost.plan_bounds, multihost._run_decode_distributed
multihost.plan_bounds = lambda *a: planned.append(plan(*a)) or planned[-1]
multihost._run_decode_distributed = lambda *a: decoded.append(1) or decode(*a)
report, how, args = sys.argv[1], sys.argv[2], sys.argv[3:]
if how == "cli":
    from blt_tpu_torch import cli
    rc = cli.main(args)
else:
    import blt_tpu_torch as blt
    rules = {(a, b): v for a, b, v in json.load(open(args[0]))}
    blt.ByteTokenizer(merges=rules, engine="torch", chunk_size=args[3]).tokenize_file(
        args[1], args[2])
    rc = 0
launches = {k: v for m in (bpe_cuda, multipass_cuda) for k, v in m.launches.items() if v}
with open(f"{report}.{os.environ['BLT_PROCESS_ID']}.json", "w") as f:
    json.dump({"launches": launches, "loops": multipass_cuda.loop_log,
               "bounds": planned, "decoded": bool(decoded)}, f)
sys.exit(rc)
"""


def run_processes(args, workdir: str, label: str, n: int = 2, timeout: float = 600) -> float:
    """``n`` processes of ``python3 args`` under the multi-process contract
    (gloo on 127.0.0.1, all on this machine's card). Waits for every rank;
    one that fails or outlives ``timeout`` fails the phase, and every
    process still running is killed. Returns the wall seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(BLT_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               BLT_NUM_PROCESSES=str(n))
    logs = [os.path.join(workdir, f"{label}.rank{r}.log") for r in range(n)]
    t0 = time.perf_counter()
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, *args], env={**env, "BLT_PROCESS_ID": str(r)},
                    cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            fail(f"{label}: rank {r} exited {p.returncode} after {seconds:.1f} s: {tail}")
    return seconds


def phase_shard(corpus, inp, workdir, flat_legs, multipass_legs, rules, merges500,
                rows: int = 4, chunk: int = 16 * MIB):
    """Phase 6b: (a) ``ShardedTorchEngine(devices=[cuda:0] * rows)`` through
    ``run_tokenizer`` on phases 4 and 5's legs and a degenerate flat leg,
    then one leg through ``cli.main(... --engine shard)`` (one row a card);
    (b) two processes of the CLI (the API for leg 4's table) on this card,
    joined over gloo. Each output is held against its reference; the launch
    counters, set to 0 before each leg, must equal what the leg dispatched
    (K1 the rows, fused K2 the slabs, K3 / K4 the rounds)."""
    from pathlib import Path

    import numpy as np
    import torch

    from blt_tpu_torch import cli
    from blt_tpu_torch.config import ContentType, CoreConfig
    from blt_tpu_torch.ops import multipass_cuda
    from blt_tpu_torch.pipeline.engines import ShardedTorchEngine
    from blt_tpu_torch.pipeline.runner import run_tokenizer

    engine = ShardedTorchEngine(devices=[torch.device("cuda", 0)] * rows)
    out = os.path.join(workdir, "out_shard.bin")
    header = (0xFF01).to_bytes(2, "big")  # the text content-type token

    def run_leg(src, merges=None, general=None, content_type=ContentType.TEXT):
        config = CoreConfig.new_from_cli(
            input=Path(src), output=Path(out), merges=Path(merges) if merges else None,
            content_type=content_type, chunksize=f"{chunk // 1024}KB")
        if general is not None:
            config.with_merges(general)
        for k in engine.counts:
            engine.counts[k] = 0
        reset_all_launches()  # the counts of this leg alone
        t0 = time.perf_counter()
        run_tokenizer(config, engine=engine)
        seconds = time.perf_counter() - t0
        got = {k: v for k, v in all_launches().items() if v}
        sha, out_bytes = sha256_file(out), os.path.getsize(out)
        os.unlink(out)
        return {"rows": rows, "processes": 1, "seconds": seconds, "output_bytes": out_bytes,
                "sha256": sha, "launches": got, "counts": dict(engine.counts),
                "loops": list(multipass_cuda.loop_log)}

    def check(name, r, ref, kernel, want):
        if r["sha256"] != ref:
            fail(f"shard leg {name}: sha256 {r['sha256']} != reference {ref}")
        if set(r["launches"]) - {kernel} or r["launches"].get(kernel, 0) != want or not want:
            fail(f"shard leg {name}: launches {r['launches']}, expected {want} of {kernel}")

    from blt_tpu_torch.pipeline.runner import _device_batch_bytes, _plan_feed_size

    size = corpus.shape[0]
    # the runner feeds flat and basic legs in batches of ``feed`` bytes, a
    # row (and a slab's payload) ``row_bytes`` of each
    feed = _plan_feed_size(chunk, _device_batch_bytes())
    row_bytes = engine._row_bytes(feed)
    batches = -(-size // feed)

    def slabs_of(n):
        return sum(-(-min(feed, n - s) // row_bytes) for s in range(0, n, feed))

    # (a) in process, every leg of phases 4 and 5 over four rows: bpe_500 on
    # the whole corpus, the others on its first 256 MiB (leg 5's input),
    # each against a reference of what it read
    head = multipass_legs["multipass_sort"]
    head_bytes = os.path.getsize(head["src"])
    for name, leg in flat_legs.items():
        if name == "bpe_500":
            src, n, ref = inp, size, leg["sha256"]
        else:
            src, n = head["src"], head_bytes
            dense = dense_of(numbered(merges_file_pairs(leg["merges"]))) if leg["merges"] else None
            ref = reference_sha(corpus[:n], dense, header)
        r = run_leg(src, leg["merges"])
        r.pop("loops")
        # K1 a non-empty row, fused K2 a slab, and no carry batch
        check(name, r, ref, "widen" if name == "basic" else "flat_bpe_packed", slabs_of(n))
        if r["counts"]["carry_batches"]:
            fail(f"shard leg {name}: {r['counts']}, expected no carry-composition batch")
        emit({"phase": "shard", "leg": name, "input_bytes": n,
              "one_row_seconds": leg["seconds"], "one_row_input_bytes": size, **r})
    for name, leg in multipass_legs.items():
        mode = "sort" if name == "multipass_sort" else "gap"
        os.environ["BLT_MP_COMPACT"] = mode
        try:
            r = run_leg(head["src"], general=rules, content_type=None)
        finally:
            del os.environ["BLT_MP_COMPACT"]
        kernel = "token_pass_lookback" if mode == "sort" else "token_pass_gap"
        if len(r["loops"]) != -(-head_bytes // chunk):
            fail(f"shard leg {name}: {len(r['loops'])} loops for {head_bytes} bytes")
        # gap and sort loops give the same tokens: leg 5's reference
        check(name, r, head["sha256"], kernel, sum(n for n, _ in r.pop("loops")))
        emit({"phase": "shard", "leg": name, "compact": mode, "input_bytes": head_bytes,
              "one_row_seconds": leg["seconds"],
              "one_row_input_bytes": os.path.getsize(leg["src"]), **r})

    # a degenerate flat leg: runs of one byte x across slab boundaries (batch
    # 1's and batch 3's second slab) send those batches through the carry
    # composition; odd run lengths leave merges pending at their ends
    degen = np.array(corpus[: min(64 * MIB, size)])
    carried = set()  # the batches whose second slab's halo is all x
    for center in (feed + row_bytes, 3 * feed + row_bytes):
        if center + 700 <= degen.shape[0]:
            degen[center - 1501 : center + 700] = DEGENERATE_BYTE
            carried.add(center // feed)
    n = degen.shape[0]
    packed_slabs = sum(-(-min(feed, n - s) // row_bytes) for s in range(0, n, feed)
                       if s // feed not in carried)
    pairs = list(merges500) + [(DEGENERATE_BYTE, DEGENERATE_BYTE)]
    degen_in = os.path.join(workdir, "degenerate.bin")
    degen_merges = os.path.join(workdir, "merges_degenerate.txt")
    degen.tofile(degen_in)
    write_merges(degen_merges, pairs)
    r = run_leg(degen_in, degen_merges)
    r.pop("loops")
    ref = reference_sha(degen, dense_of(numbered(pairs)), header)
    check("degenerate", r, ref, "flat_bpe_packed", packed_slabs)
    if r["counts"]["carry_batches"] != len(carried) or not carried:
        fail(f"shard leg degenerate: {r['counts']}, expected {len(carried)} batches "
             "through the carry composition")
    emit({"phase": "shard", "leg": "degenerate", "input_bytes": int(degen.shape[0]),
          "carry_composition_batches": r["counts"]["carry_batches"], **r})
    os.unlink(degen_in)

    # the CLI's --engine shard: one row a card on this machine
    cli_out = os.path.join(workdir, "out_shard_cli.bin")
    reset_all_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-i", inp, "-o", cli_out, "--engine", "shard", "--type", "text",
                   "--chunksize", f"{chunk // 1024}KB", "--merges", flat_legs["bpe_500"]["merges"]])
    seconds = time.perf_counter() - t0
    got = {k: v for k, v in all_launches().items() if v}
    r = {"rows": torch.cuda.device_count(), "processes": 1, "seconds": seconds,
         "sha256": sha256_file(cli_out), "launches": got}
    os.unlink(cli_out)
    if rc != 0:
        fail(f"cli --engine shard returned {rc}")
    check("cli_bpe_500", r, flat_legs["bpe_500"]["sha256"], "flat_bpe_packed",
          batches * torch.cuda.device_count())
    emit({"phase": "shard", "leg": "cli_bpe_500", "input_bytes": size,
          "one_row_seconds": flat_legs["bpe_500"]["seconds"], **r})

    # (b) two processes on this card, over gloo. Each rank runs through
    # RANK_WRAPPER, which reports its launches, its loops and the bounds its
    # runner planned; each rank's launches must be what its byte range gives
    def mp_leg(name, how, args, target, ref, src_bytes, one_row_seconds, kernel, per_rank):
        report = os.path.join(workdir, f"{name}.report")
        seconds = run_processes(["-c", RANK_WRAPPER, report, how, *args], workdir, name)
        sha = sha256_file(target)
        if sha != ref:
            fail(f"two-process leg {name}: sha256 {sha} != reference {ref}")
        ranks = []
        for r in range(2):
            with open(f"{report}.{r}.json") as f:
                ranks.append(json.load(f))
        launches, expected = {}, 0
        for r, rep in enumerate(ranks):
            if kernel is None:  # decode: the host's work, no kernel
                if not rep["decoded"] or rep["launches"]:
                    fail(f"two-process leg {name}: rank {r} {rep}, expected a "
                         "distributed decode and no launch")
                continue
            plans = rep["bounds"]
            if (len(plans) != 1 or plans != ranks[0]["bounds"] or len(plans[0]) != 3
                    or plans[0][0] != 0 or plans[0][-1] != src_bytes):
                fail(f"two-process leg {name}: rank {r} planned {plans}, expected one "
                     f"split of [0, {src_bytes}) shared by both ranks")
            lo, hi = plans[0][r], plans[0][r + 1]
            want = per_rank(r, lo, hi, rep["loops"])
            if set(rep["launches"]) - {kernel} or rep["launches"].get(kernel, 0) != want:
                fail(f"two-process leg {name}: rank {r} on [{lo}, {hi}) launched "
                     f"{rep['launches']}, expected {want} of {kernel}")
            for k, v in rep["launches"].items():
                launches[k] = launches.get(k, 0) + v
            expected += want
        if kernel is not None and not expected:
            fail(f"two-process leg {name}: no launch of {kernel}")
        emit({"phase": "shard", "leg": name, "rows": 1, "processes": 2, "input_bytes": src_bytes,
              "seconds": seconds, "one_process_seconds": one_row_seconds, "sha256": sha,
              "output_bytes": os.path.getsize(target), "launches": launches,
              "launches_expected": expected, "bounds": ranks[0]["bounds"]})

    def batches_of(r, lo, hi, loops):  # the runner's feed batches in [lo, hi)
        return -(-(hi - lo) // feed)

    def rounds_of(r, lo, hi, loops):  # K3 a round, over one loop a chunk
        if len(loops) != -(-(hi - lo) // chunk):
            fail(f"two-process leg mp_multipass_gap: rank {r} ran {len(loops)} loops "
                 f"on [{lo}, {hi})")
        return sum(n for n, _ in loops)

    cli_args = ["--engine", "torch", "--type", "text", "--chunksize", f"{chunk // 1024}KB",
                "-i", inp]
    wire = os.path.join(workdir, "mp_bpe_500.bin")
    mp_leg("mp_bpe_500", "cli", cli_args + ["-o", wire, "--merges", flat_legs["bpe_500"]["merges"]],
           wire, flat_legs["bpe_500"]["sha256"], size, flat_legs["bpe_500"]["seconds"],
           "flat_bpe_packed", batches_of)
    basic_out = os.path.join(workdir, "mp_basic.bin")
    mp_leg("mp_basic", "cli", cli_args + ["-o", basic_out], basic_out, flat_legs["basic"]["sha256"],
           size, flat_legs["basic"]["seconds"], "widen", batches_of)
    os.unlink(basic_out)
    # leg 4's table has token keys, which a merges file cannot hold: the API
    rules_json = os.path.join(workdir, "rules.json")
    with open(rules_json, "w") as f:
        json.dump([[a, b, v] for (a, b), v in rules.items()], f)
    general_out = os.path.join(workdir, "mp_multipass_gap.bin")
    mp_leg("mp_multipass_gap", "api", [rules_json, inp, general_out, f"{chunk // 1024}KB"],
           general_out, multipass_legs["multipass_gap"]["sha256"], size,
           multipass_legs["multipass_gap"]["seconds"], "token_pass_gap", rounds_of)
    os.unlink(general_out)
    back = os.path.join(workdir, "mp_decoded.bin")
    mp_leg("mp_decode_bpe_500", "cli",
           ["--decode", "--type", "text", "--merges", flat_legs["bpe_500"]["merges"],
            "-i", wire, "-o", back],
           back, sha256_file(inp), os.path.getsize(wire), None, None, None)
    os.unlink(wire)
    os.unlink(back)


def _http(addr, method, path, body=b""):
    """One request to a server at ``addr``. Returns (status, body, seconds
    from the send to the last byte of the answer)."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body)
        r = conn.getresponse()
        data = r.read()
        return r.status, data, time.perf_counter() - t0
    finally:
        conn.close()


def _serving(srv):
    """Start ``srv.serve_forever`` on a thread; returns the address."""
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv.server_address[:2]


def _stop(*servers):
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _percentiles(values) -> dict:
    import numpy as np

    v = np.asarray(values, dtype=np.float64)
    return {"n": int(v.size), "p50_s": float(np.percentile(v, 50)),
            "p99_s": float(np.percentile(v, 99)), "max_s": float(v.max())}


def serve_process(m500, warmup, body):
    """``python -m blt_tpu_torch.server --engine torch --merges m500`` (with
    ``--warmup 16MB`` when ``warmup``) as a process: seconds from its start
    until /health answers, then the latency of ``body`` as a BPE request,
    twice. The process is stopped (SIGINT, then killed) before returning."""
    import signal

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, "-m", "blt_tpu_torch.server", "--engine", "torch",
            "--merges", m500, "--port", str(port)] + (["--warmup", "16MB"] if warmup else [])
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        while True:
            if proc.poll() is not None:
                fail(f"server process exited {proc.returncode}: "
                     f"{proc.stderr.read().decode()[-2000:]}")
            if time.perf_counter() - t0 > 300:
                fail("server process: /health did not answer in 300 s")
            try:
                status, _, _ = _http(("127.0.0.1", port), "GET", "/health")
                if status == 200:
                    break
            except OSError:
                time.sleep(0.05)
        health_s = time.perf_counter() - t0
        firsts = []
        for _ in range(2):
            status, out, seconds = _http(("127.0.0.1", port), "POST", "/tokenize", body)
            if status != 200:
                fail(f"server process answered {status}: {out[:200]!r}")
            firsts.append((seconds, hashlib.sha256(out).hexdigest()))
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fail("server process did not stop on SIGINT")
        if rc != 0:
            fail(f"server process exited {rc} on SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"warmup": warmup, "health_s": health_s, "first_request_s": firsts[0][0],
            "second_request_s": firsts[1][0], "sha256": firsts[0][1],
            "same_both_times": firsts[0][1] == firsts[1][1]}


def phase_serve(corpus, workdir, m500, merges500, merges50k, rules):
    """Phase 6c: the HTTP server on the card (``blt_tpu_torch.server``).

    In process, each server on a thread of this process: the 500-pair table
    warmed to 16 MiB, a server without merges and one with the 50k table;
    sequential requests of 1 KiB to 64 MiB in BPE, basic and passthrough
    mode and a /detokenize, each body's sha256 held against the NumPy
    reference and each request's launches read from the counters (set to 0
    before it): one fused K2 a non-empty BPE request, one K1 a basic one,
    none for passthrough, detokenize and an empty body. Then leg 4's
    table (a 16 MiB request, K3 rounds, and again under
    ``BLT_MP_COMPACT=sort``, K4 rounds), eight concurrent clients, ``engine
    auto`` at a 1 MiB threshold, ``engine shard``; the server as a process
    with and without ``--warmup``; one BPE leg of the CLI under
    ``BLT_PROFILE``. Returns the phase's launches by kernel."""
    import concurrent.futures

    import numpy as np
    import torch

    from blt_tpu_torch import cli
    from blt_tpu_torch.merges import MergeTable, load_bpe_merges_from_path
    from blt_tpu_torch.ops import multipass_cuda
    from blt_tpu_torch.ops.bpe_cuda import CudaFlatEncoder
    from blt_tpu_torch.pipeline.feeder import pinned_buffer, prefetch_iter
    from blt_tpu_torch.pipeline.runner import _device_batch_bytes, _plan_feed_size
    from blt_tpu_torch.server import make_server
    from blt_tpu_torch.warmup import pow2_buckets

    KIB = 1024
    header = (0xFF01).to_bytes(2, "big")  # the text content-type token
    dense500 = dense_of(numbered(merges500))
    totals = {}
    phase_t0 = time.perf_counter()

    def counted(fn, kernel, want):
        """Run ``fn`` with the counters at 0; fail unless it launched
        ``want`` of ``kernel`` and nothing else. Returns fn's result."""
        reset_all_launches()
        result = fn()
        got = {k: v for k, v in all_launches().items() if v}
        if set(got) - {kernel} or got.get(kernel, 0) != want:
            fail(f"serve: launched {got}, expected {want} of {kernel}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        return result

    def request(addr, path, body, kernel, want, ref):
        status, out, seconds = counted(lambda: _http(addr, "POST", path, body), kernel, want)
        sha = hashlib.sha256(out).hexdigest()
        if status != 200 or sha != ref:
            fail(f"serve {path} of {len(body)} bytes: status {status}, sha256 {sha} != {ref}")
        return out, seconds

    outputs = {}  # (offset, size, rules) -> the reference's output bytes

    def bpe_ref(off, size, head=b"", pairs=merges500):
        """sha256 of ``head`` + the flat-BPE reference of corpus[off:off+size]."""
        key = (off, size, len(pairs))
        if key not in outputs:
            dense = dense500 if pairs is merges500 else dense_of(numbered(pairs))
            outputs[key] = b"".join(flat_bpe_reference(corpus[off : off + size], dense))
        return hashlib.sha256(head + outputs[key]).hexdigest()

    # (1) the 500-pair server warmed to 16 MiB, and a server without merges
    reset_all_launches()
    t0 = time.perf_counter()
    bpe_srv = make_server(port=0, merges_path=m500, engine="torch", warmup_bytes=16 * MIB)
    warm_s = time.perf_counter() - t0
    warm_launches = {k: v for k, v in all_launches().items() if v}
    if warm_launches != {"flat_bpe_packed": len(pow2_buckets(16 * MIB))}:
        fail(f"serve warm-up: launched {warm_launches}, expected one fused K2 a bucket")
    basic_srv = make_server(port=0, engine="torch")
    bpe_addr, basic_addr = _serving(bpe_srv), _serving(basic_srv)
    sizes = [KIB, 64 * KIB, MIB, 16 * MIB, 64 * MIB]
    rows = []
    try:
        request(bpe_addr, "/tokenize?type=text", b"", "flat_bpe_packed", 0,
                hashlib.sha256(header).hexdigest())
        for size in sizes:
            data = corpus[:size]
            body = data.tobytes()
            row = {"bytes": size}
            out, row["bpe_s"] = request(bpe_addr, "/tokenize", body, "flat_bpe_packed", 1,
                                        bpe_ref(0, size))
            if size == 16 * MIB:
                back, row["detokenize_s"] = request(bpe_addr, "/detokenize", out, None, 0,
                                                    hashlib.sha256(body).hexdigest())
            _, row["basic_s"] = request(basic_addr, "/tokenize?type=text", body, "widen", 1,
                                        reference_sha(data, None, header))
            _, row["passthrough_s"] = request(bpe_addr, "/tokenize?mode=passthrough", body,
                                              None, 0, hashlib.sha256(body).hexdigest())
            rows.append(row)
        emit({"phase": "serve", "part": "sequential", "warmup_bytes": 16 * MIB,
              "warmup_s": warm_s, "warmup_launches": warm_launches, "requests": rows})

        # (4) eight clients, 64 requests of 64 KiB-16 MiB, BPE and passthrough
        rng = np.random.default_rng(18)
        slices = [(int(rng.integers(0, corpus.shape[0] - s)), s)
                  for s in (64 * KIB, 256 * KIB, MIB, 4 * MIB, 16 * MIB) for _ in range(2)]
        refs = {}
        for off, s in slices:
            data = corpus[off : off + s]
            refs[(off, s, "bpe")] = bpe_ref(off, s, header)
            refs[(off, s, "passthrough")] = hashlib.sha256(data.tobytes()).hexdigest()
        jobs = [(*slices[int(rng.integers(0, len(slices)))], mode)
                for mode in ("bpe", "bpe", "bpe", "passthrough") for _ in range(16)]
        rng.shuffle(jobs)
        bodies = {(off, s): corpus[off : off + s].tobytes() for off, s in slices}

        def client(job):
            off, s, mode = job
            path = "/tokenize?type=text" if mode == "bpe" else "/tokenize?mode=passthrough"
            status, out, seconds = _http(bpe_addr, "POST", path, bodies[(off, s)])
            return status, hashlib.sha256(out).hexdigest(), seconds

        n_bpe = sum(mode == "bpe" for _, _, mode in jobs)

        def concurrent_run():
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                results = list(pool.map(client, jobs))
            return results, time.perf_counter() - t0

        results, wall = counted(concurrent_run, "flat_bpe_packed", n_bpe)
        for job, (status, sha, _) in zip(jobs, results):
            if status != 200 or sha != refs[job]:
                fail(f"serve concurrent {job}: status {status}, sha256 {sha} != {refs[job]}")
        by_size = {}
        for (_, s, _), (_, _, seconds) in zip(jobs, results):
            by_size.setdefault(s, []).append(seconds)
        in_bytes = sum(s for _, s, _ in jobs)
        emit({"phase": "serve", "part": "concurrent", "clients": 8, "requests": len(jobs),
              "bpe_requests": n_bpe, "input_bytes": in_bytes, "wall_s": wall,
              "aggregate_MB_per_s": in_bytes / wall / 1e6,
              "latency_by_size": {str(s): _percentiles(v) for s, v in sorted(by_size.items())}})

        # the per-request costs of a flat request on the card, each alone
        device = torch.device("cuda", 0)
        table500 = MergeTable.build(load_bpe_merges_from_path(m500))
        costs = {}
        for cap in (MIB, 16 * MIB, 64 * MIB):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                CudaFlatEncoder(table500, device, cap)  # the wire table upload, a copy stream
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pinned_buffer(cap, device)
                t2 = time.perf_counter()
                times.append((t1 - t0, t2 - t1))
            costs[str(cap)] = {"encoder_ms": [1e3 * a for a, _ in times],
                               "pinned_staging_ms": [1e3 * b for _, b in times]}
        t0 = time.perf_counter()
        for _ in range(10):  # a flat request's three stages, over nothing
            list(prefetch_iter(prefetch_iter(prefetch_iter(iter(()), 2, "a"), 2, "b"), 2, "c"))
        costs["three_stage_threads_ms"] = (time.perf_counter() - t0) * 1e2
        emit({"phase": "serve", "part": "request_costs", **costs})
    finally:
        _stop(bpe_srv, basic_srv)

    # (2) the 50k-rule table at 64 MiB
    m50k = os.path.join(workdir, "merges_50k.txt")
    write_merges(m50k, merges50k)
    srv = make_server(port=0, merges_path=m50k, engine="torch")
    try:
        data = corpus[: 64 * MIB]
        _, seconds = request(_serving(srv), "/tokenize", data.tobytes(), "flat_bpe_packed", 1,
                             bpe_ref(0, 64 * MIB, pairs=merges50k))
    finally:
        _stop(srv)
    emit({"phase": "serve", "part": "bpe_50k", "bytes": 64 * MIB, "seconds": seconds})

    # (3) leg 4's 8000-rule table: one 16 MiB request, the K3 loop, then the K4 loop
    data = corpus[: 16 * MIB]
    t0 = time.perf_counter()
    keys, vals = rule_arrays(rules)
    ref = hashlib.sha256(multipass_reference(data, keys, vals).astype(">u2").tobytes()).hexdigest()
    ref_s = time.perf_counter() - t0
    srv = make_server(port=0, engine="torch", table=MergeTable.build(rules))
    general = {"bytes": 16 * MIB, "reference_s": ref_s}
    try:
        addr = _serving(srv)
        for mode, kernel in (("gap", "token_pass_gap"), ("sort", "token_pass_lookback")):
            os.environ["BLT_MP_COMPACT"] = mode
            try:
                multipass_cuda.loop_log.clear()
                reset_all_launches()
                status, out, seconds = _http(addr, "POST", "/tokenize", data.tobytes())
                got = {k: v for k, v in all_launches().items() if v}
            finally:
                del os.environ["BLT_MP_COMPACT"]
            loops = list(multipass_cuda.loop_log)
            rounds = sum(r for r, _ in loops)
            sha = hashlib.sha256(out).hexdigest()
            if status != 200 or sha != ref:
                fail(f"serve leg 4 ({mode}): status {status}, sha256 {sha} != {ref}")
            if len(loops) != 1 or got != {kernel: rounds}:
                fail(f"serve leg 4 ({mode}): launched {got}, loops {loops}")
            totals[kernel] = totals.get(kernel, 0) + rounds
            general[mode] = {"seconds": seconds, "rounds": rounds, "launches": got}
    finally:
        _stop(srv)
    emit({"phase": "serve", "part": "general", **general})

    # (5) engine auto at a 1 MiB threshold: below it the host, at or above it K2
    srv = make_server(port=0, merges_path=m500, engine="auto", device_threshold=MIB)
    auto = []
    try:
        addr = _serving(srv)
        for size in (64 * KIB, MIB - 1, MIB, 4 * MIB):
            data = corpus[:size]
            want = int(size >= MIB)
            _, seconds = request(addr, "/tokenize", data.tobytes(),
                                 "flat_bpe_packed" if want else None, want, bpe_ref(0, size))
            auto.append({"bytes": size, "launches": want, "seconds": seconds})
    finally:
        _stop(srv)
    emit({"phase": "serve", "part": "auto", "device_threshold": MIB, "requests": auto})

    # (6) engine shard: one row a card on this machine
    srv = make_server(port=0, merges_path=m500, engine="shard")
    shard = []
    try:
        addr = _serving(srv)
        for size in (16 * MIB, 64 * MIB):
            data = corpus[:size]
            _, seconds = request(addr, "/tokenize?type=text", data.tobytes(), "flat_bpe_packed",
                                 torch.cuda.device_count(), bpe_ref(0, size, header))
            shard.append({"bytes": size, "seconds": seconds})
        if srv.RequestHandlerClass.engine.counts["carry_batches"]:
            fail("serve shard: a request took the carry composition")
    finally:
        _stop(srv)
    emit({"phase": "serve", "part": "shard", "rows": torch.cuda.device_count(),
          "requests": shard})

    # (7) the server as a process, warmed and not: what the warm-up buys
    body = corpus[:MIB].tobytes()
    ref = bpe_ref(0, MIB)
    procs = [serve_process(m500, warm, body) for warm in (True, False)]
    for p in procs:
        if p.pop("sha256") != ref or not p["same_both_times"]:
            fail(f"serve process: a 1 MiB answer differs from the reference: {p}")
    emit({"phase": "serve", "part": "process", "request_bytes": MIB, "runs": procs})

    # (8) one BPE leg of the CLI under BLT_PROFILE: the trace names the fused K2
    src = os.path.join(workdir, "serve_profile.bin")
    corpus[: 64 * MIB].tofile(src)
    traces = os.path.join(workdir, "serve_traces")
    os.environ["BLT_PROFILE"] = traces
    try:
        rc = counted(lambda: cli.main(["-i", src, "-o", src + ".out", "--engine", "torch",
                                       "--merges", m500, "--chunksize", "16MB"]),
                     "flat_bpe_packed", -(-64 * MIB // _plan_feed_size(16 * MIB, _device_batch_bytes())))
    finally:
        del os.environ["BLT_PROFILE"]
    files = os.listdir(traces)
    if rc != 0 or len(files) != 1:
        fail(f"serve profile: rc {rc}, trace files {files}")
    with open(os.path.join(traces, files[0])) as f:
        trace = f.read()
    if "flat_packed_kernel" not in trace or sha256_file(src + ".out") != bpe_ref(0, 64 * MIB):
        fail("serve profile: the trace does not name flat_packed_kernel, or the output differs")
    emit({"phase": "serve", "part": "profile", "trace_bytes": len(trace),
          "names_flat_packed_kernel": True,
          "flat_packed_kernel_events": trace.count("flat_packed_kernel"),
          "phase_seconds": time.perf_counter() - phase_t0, "launches": totals})
    return totals


# --- phase 6d: training ---------------------------------------------------------

# the steps of a training round, in order, as phase 6d splits it
TRAIN_STEPS = ("count", "argmax_read", "match_scan", "compact")


def merge_pair_reference(t, a: int, b: int, new_id: int):
    """One merge pass of the rule (a, b) -> ``new_id`` over int32 tokens
    ``t``: its leftmost-first non-overlapping occurrences become ``new_id``
    and lose their second token. Occurrences overlap only when a == b (a
    run of equal tokens); there every other one from the run's start
    merges."""
    import numpy as np

    m = np.flatnonzero((t[:-1] == a) & (t[1:] == b))
    if a == b and m.size > 1:
        head = np.ones(m.size, bool)
        head[1:] = np.diff(m) != 1
        k = np.arange(m.size)
        m = m[(k - np.maximum.accumulate(np.where(head, k, 0))) % 2 == 0]
    out = t.copy()
    out[m] = new_id
    return np.delete(out, m + 1)


def train_reference(path: str, size: int, rows: int, num_merges: int) -> list:
    """Greedy BPE training on the host, independent of both packages. The
    first ``size`` bytes of ``path`` are cut into rows of ceil(size / rows)
    bytes (the last one short). Each round counts the adjacent pairs within
    every row (none across two rows), takes the most frequent pair (the
    smallest ``a * V + b`` among equals, V = 256 + num_merges), stops when
    it occurs under twice, and merges it in every row. Returns the rules
    in order, as (a, b) tuples."""
    import numpy as np

    data = np.fromfile(path, np.uint8, count=size)
    step = -(-size // rows)
    seqs = [data[s : s + step].astype(np.int32) for s in range(0, size, step)]
    vocab = 256 + num_merges
    rules = []
    for new_id in range(256, 256 + num_merges):
        hist = np.zeros(vocab * vocab, np.int64)
        for t in seqs:
            hist += np.bincount(t[:-1].astype(np.int64) * vocab + t[1:],
                                minlength=vocab * vocab)
        best = int(np.argmax(hist))  # the first maximum
        if hist[best] < 2:
            break
        a, b = divmod(best, vocab)
        rules.append((a, b))
        seqs = [merge_pair_reference(t, a, b, new_id) for t in seqs]
    return rules


def train_step_bytes(width: int, live: int, vocab: int) -> dict:
    """The bytes each step of a round must move, each input read and each
    output written once: the count reads ``width`` int32 tokens and writes
    the int32 (V, V) histogram; the argmax reads the histogram and writes
    the index, its count and the longest length; the match and scan read
    the ``live`` tokens and write one bool a position; the compaction reads
    those tokens and bools and writes the tokens."""
    hist = 4 * vocab * vocab
    return {"count": 4 * width + hist, "argmax_read": hist + 24,
            "match_scan": 4 * live + live, "compact": 5 * live + 4 * live}


def train_rounds(tokens, length, vocab: int, rules, split=None, moved=None):
    """Replay ``learn_bpe``'s rounds for ``rules`` from ``tokens`` through
    ``parallel.train``'s steps, each round's pick held equal to its rule.
    With ``split`` and ``moved`` (dicts by ``TRAIN_STEPS``), CUDA events
    between the steps add each step's milliseconds to ``split`` and the
    bytes it must move (``train_step_bytes``) to ``moved``."""
    import torch

    from blt_tpu_torch.parallel import train

    for new_id, (a, b) in enumerate(rules, 256):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)] if split is not None else []

        def mark(i):
            if ev:
                ev[i].record()

        width = tokens.shape[-1]
        mark(0)
        hist = train._count_pairs(tokens, length, vocab)
        mark(1)
        best, _, live = train._best(hist, length)  # the round's one host read
        mark(2)
        tokens = tokens[:live]
        starts = train._merge_starts(tokens, length, a, b)
        mark(3)
        tokens, length = train._compact_rule(tokens, length, starts, new_id)
        mark(4)
        if divmod(best, vocab) != (a, b):
            fail(f"replayed round {new_id - 256} picked {divmod(best, vocab)}, learned {(a, b)}")
        if ev:
            ev[4].synchronize()
            for i, (step, nbytes) in enumerate(train_step_bytes(width, live, vocab).items()):
                split[step] += ev[i].elapsed_time(ev[i + 1])
                moved[step] += nbytes
    return tokens, length


def train_glue_alternatives(tokens, length, vocab: int) -> dict:
    """The first round's count and scan at full width beside one PyTorch
    call of the same function, each held equal to it: the count beside
    ``torch.bincount`` (int64 bins), ``_last_nonmatch`` over the matches of
    the rule (x, x), x the most frequent token, beside ``torch.cummax`` of
    the sentinel (the JAX trainer's scan; timed once). Milliseconds."""
    import torch

    from blt_tpu_torch.parallel import train

    hist = train._count_pairs(tokens, length, vocab)

    def bincount():
        return torch.bincount(tokens[:-1].to(torch.int64) * vocab + tokens[1:],
                              minlength=vocab * vocab)

    if not torch.equal(bincount().to(torch.int32), hist):
        fail("torch.bincount's pair counts differ from _count_pairs'")
    x = int(torch.bincount(tokens).argmax())
    match = (tokens == x) & (torch.roll(tokens, -1) == x)
    match[-1] = False
    idx = torch.arange(tokens.shape[0], dtype=torch.int32, device=tokens.device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    want = torch.cummax(torch.where(match, train._NEG_INF32, idx), dim=0).values
    b.record()
    b.synchronize()
    if not torch.equal(train._last_nonmatch(match), want):
        fail("_last_nonmatch differs from torch.cummax of the sentinel")
    return {"count": cuda_ms(lambda: train._count_pairs(tokens, length, vocab), reps=3),
            "library_bincount": cuda_ms(bincount, reps=3),
            "scan_last_nonmatch": cuda_ms(lambda: train._last_nonmatch(match), reps=3),
            "library_cummax_once": a.elapsed_time(b),
            "scan_rule": [x, x], "scan_match_share": float(match.float().mean())}


def merges_file_pairs(path: str) -> list:
    """The byte pairs of a merges file's rule lines, in order (``#`` lines
    skipped): line i makes token 256 + i."""
    with open(path) as f:
        return [tuple(int(v) for v in line.split()) for line in f
                if line.strip() and not line.startswith("#")]


def run_train_cli(args):
    """``python -m blt_tpu_torch.train_cli ARGS`` as a process (started,
    not waited for: ``_wait_cli``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-m", "blt_tpu_torch.train_cli", *args],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_cli(proc, label: str, timeout: float = 600) -> None:
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{label}: the train CLI outlived {timeout} s")
    if proc.returncode != 0:
        fail(f"{label}: the train CLI exited {proc.returncode}: {err[-2000:]}")


def phase_train(corpus, workdir, head_path: str, rules_n: int = 500):
    """Phase 6d: BPE merge training on the card (``blt_tpu_torch.parallel.
    train``, ``train_cli``), and the learned table on the main path.

    (a) ``learn_bpe_sharded`` (8 rows) at 16 MiB, 500 rules; (b)
    ``learn_bpe`` at 256 MiB, 500 rules, timed whole, then 20 of its rounds
    replayed with CUDA events between the steps and 20 under
    ``torch.profiler``; (c) the train CLI as processes at 64 MiB, 8 rows:
    a clean 500-rule run, and a 250-rule run resumed to 500 from its
    checkpoint; (d) the 256 MiB table's merges file through ``cli.main``
    (K2 fused with its pack), the full learned dict through
    ``ByteTokenizer.tokenize_file`` at 64 MiB (K3 rounds). The NumPy
    references (``train_reference``, ``multipass_reference``) run on a
    process pool during (c) and (d): the tables of (a) whole and the first
    16 rules of (b) must equal theirs, (d)'s outputs their sha256. Returns
    the phase's launches by kernel."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    import torch

    import blt_tpu_torch
    from blt_tpu_torch import cli
    from blt_tpu_torch.ops import multipass_cuda
    from blt_tpu_torch.parallel import train
    from blt_tpu_torch.pipeline.runner import _device_batch_bytes, _plan_feed_size

    t_phase = time.perf_counter()
    small, mid = 16 * MIB, 64 * MIB
    head = corpus[: 256 * MIB]
    path16 = os.path.join(workdir, "train_16.bin")
    path64 = os.path.join(workdir, "train_64.bin")
    corpus[:small].tofile(path16)
    corpus[:mid].tofile(path64)
    phase_launches = {k: 0 for k in all_launches()}

    # (a) exactness at 16 MiB over 8 rows (one sequence is checked at 256
    # MiB, (b), by the first 16 rules)
    rows = 8
    batch = corpus[:small].reshape(rows, small // rows)
    t0 = time.perf_counter()
    learned16_rows = train.learn_bpe_sharded(batch, np.full(rows, small // rows, np.int32),
                                             rules_n)
    s16_rows = time.perf_counter() - t0

    # (b) the realistic size: 256 MiB, the table timed whole
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learned = train.learn_bpe(head, rules_n)
    seconds = time.perf_counter() - t0
    if len(learned) != rules_n:
        fail(f"learn_bpe at 256 MiB stopped after {len(learned)} rules")
    learned_txt = os.path.join(workdir, "learned.txt")
    train.save_merges(learned, learned_txt)
    vocab = 256 + rules_n
    dev = torch.device("cuda", 0)
    rules20 = list(learned)[:20]

    def start():
        tokens = torch.from_numpy(head).to(dev).to(torch.int32)
        return tokens, torch.tensor(head.shape[0], dtype=torch.int32, device=dev)

    split, moved = {k: 0.0 for k in TRAIN_STEPS}, {k: 0 for k in TRAIN_STEPS}
    train_rounds(*start(), vocab, rules20, split, moved)
    tokens, length = start()
    torch.cuda.synchronize()
    trace = device_profile(functools.partial(train_rounds, tokens, length, vocab, rules20))
    del tokens, length
    glue = train_glue_alternatives(*start(), vocab)
    emit({"phase": "train", "part": "learn_bpe", "input_bytes": int(head.shape[0]),
          "rules": len(learned), "rounds": len(learned), "seconds": seconds,
          "ms_per_round": seconds * 1e3 / len(learned),
          "split_rounds": len(rules20),
          "split_ms_per_round": {k: v / len(rules20) for k, v in split.items()},
          "bound_ms_per_round": {k: bytes_bound_ms(v) / len(rules20) for k, v in moved.items()},
          "round_bound_ms": bytes_bound_ms(sum(moved.values())) / len(rules20),
          "trace_rounds": len(rules20), "trace_wall_s": trace["wall_s"],
          "device_busy_s": trace["device_busy_s"], "idle_share": trace["idle_share"],
          "device_ms": dict(list(trace["device_ms"].items())[:12]),
          "round_0_ms": glue,
          "at_16_mib": {"rows_8_seconds": s16_rows, "rows_8_rules": len(learned16_rows)}})

    # the references, on a process pool while the card runs (c) and (d)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(6, mp_context=ctx) as pool:
        t_ref = time.perf_counter()
        ref16_rows = pool.submit(train_reference, path16, small, rows, rules_n)
        ref256 = pool.submit(train_reference, head_path, head.shape[0], 1, 16)
        keys, vals = rule_arrays(learned)
        ref_chunks = [pool.submit(_reference_chunk, (corpus[s : s + 16 * MIB], keys, vals))
                      for s in range(0, mid, 16 * MIB)]

        # (c) the train CLI as processes: a clean run and a 250-rule run at
        # once, then the resume
        base = [path64, "--rows", str(rows), "--checkpoint-every", "100"]
        outs = {k: os.path.join(workdir, f"cli_{k}.txt") for k in ("clean", "half", "resumed")}
        ckpt = {k: os.path.join(workdir, f"cli_{k}.npz") for k in ("clean", "half")}
        t0 = time.perf_counter()
        clean = run_train_cli([*base, "-o", outs["clean"], "-n", str(rules_n),
                               "--checkpoint", ckpt["clean"]])
        half = run_train_cli([*base, "-o", outs["half"], "-n", str(rules_n // 2),
                              "--checkpoint", ckpt["half"]])
        _wait_cli(half, "train_cli -n 250")
        s_half = time.perf_counter() - t0
        _wait_cli(clean, "train_cli -n 500")
        s_clean = time.perf_counter() - t0
        t1 = time.perf_counter()
        _wait_cli(run_train_cli([*base, "-o", outs["resumed"], "-n", str(rules_n),
                                 "--checkpoint", ckpt["half"], "--resume"]),
                  "train_cli --resume")
        s_resume = time.perf_counter() - t1
        with open(outs["clean"], "rb") as f, open(outs["resumed"], "rb") as g:
            if f.read() != g.read():
                fail("the resumed train CLI's merges file differs from the clean run's")
        a, b = np.load(ckpt["clean"]), np.load(ckpt["half"])
        for key in ("keys", "vals", "new_id", "tokens", "lengths"):
            if a[key].dtype != b[key].dtype or not np.array_equal(a[key], b[key]):
                fail(f"the resumed checkpoint's {key} differs from the clean run's")
        emit({"phase": "train", "part": "cli", "input_bytes": mid, "rows": rows,
              "rules": int(a["new_id"]) - 256, "seconds_clean": s_clean,
              "seconds_250": s_half, "seconds_resume": s_resume, "equal": True,
              "checkpoint_new_id": int(a["new_id"])})

        # (d) the learned table on the main path: its merges file (byte
        # pairs only) through K2 fused with its pack, the whole dict through
        # the K3 loop
        out = os.path.join(workdir, "learned_out.bin")
        reset_all_launches()
        t0 = time.perf_counter()
        if cli.main(["-i", head_path, "-o", out, "--engine", "torch", "--merges",
                     learned_txt, "--chunksize", "16MB"]) != 0:
            fail("the learned merges file: cli.main failed")
        s_flat = time.perf_counter() - t0
        got = all_launches()
        batches = -(-head.shape[0] // _plan_feed_size(16 * MIB, _device_batch_bytes()))
        if got["flat_bpe_packed"] != batches:
            fail(f"the learned merges file: launches {got}, expected {batches} batches")
        for k, v in got.items():
            phase_launches[k] += v
        file_pairs = merges_file_pairs(learned_txt)
        sha_flat = sha256_file(out)
        ref_flat = reference_sha(head, dense_of(numbered(file_pairs)), b"")
        if sha_flat != ref_flat:
            fail(f"the learned merges file: sha256 {sha_flat} != reference {ref_flat}")
        reset_all_launches()
        t0 = time.perf_counter()
        blt_tpu_torch.ByteTokenizer(merges=learned, engine="torch",
                                    chunk_size="16MB").tokenize_file(path64, out)
        s_dict = time.perf_counter() - t0
        got = all_launches()
        rounds = [r for r, _ in multipass_cuda.loop_log]
        if len(rounds) != mid // (16 * MIB) or got["token_pass_gap"] != sum(rounds):
            fail(f"the learned dict: launches {got}, rounds {rounds}")
        for k, v in got.items():
            phase_launches[k] += v
        sha_dict = sha256_file(out)
        os.unlink(out)

        # the references' verdicts
        h = hashlib.sha256()
        for job in ref_chunks:
            h.update(job.result())
        ref_dict = h.hexdigest()
        if sha_dict != ref_dict:
            fail(f"the learned dict: sha256 {sha_dict} != reference {ref_dict}")
        checks = {"learn_bpe_sharded_16": (list(learned16_rows), ref16_rows.result()),
                  "learn_bpe_256_first_16": (list(learned)[:16], ref256.result())}
        for name, (got_rules, want) in checks.items():
            if got_rules != want:
                first = next((i for i, (x, y) in enumerate(zip(got_rules, want)) if x != y),
                             min(len(got_rules), len(want)))
                fail(f"{name}: the card's table differs from the reference at rule {first} "
                     f"({len(got_rules)} against {len(want)} rules)")
        ref_seconds = time.perf_counter() - t_ref
    emit({"phase": "train", "part": "main_path", "file_rules": len(file_pairs),
          "flat": {"input_bytes": int(head.shape[0]), "batches": batches,
                   "seconds": s_flat, "sha256": sha_flat},
          "dict": {"input_bytes": mid, "rules": len(learned), "chunks": len(rounds),
                   "rounds": rounds, "seconds": s_dict, "sha256": sha_dict},
          "launches": {k: v for k, v in phase_launches.items() if v}})
    emit({"phase": "train", "part": "references", "equal": True,
          "tables": {k: len(w) for k, (_, w) in checks.items()},
          "seconds_after_start": ref_seconds, "phase_seconds": time.perf_counter() - t_phase})
    for p in (path16, path64):
        os.unlink(p)
    return phase_launches


# --- phase 6e: the fuzzer and the conformance goldens ------------------------------

# make_conformance's goldens and the CLI flags that reproduce each
GOLDENS = {"golden_basic.bin": [], "golden_passthrough.bin": ["--passthrough"],
           "golden_bpe.bin": ["--merges", "merges.txt", "--chunksize", "128MB"],
           "golden_basic_type_text.bin": ["--type", "text"]}


def phase_fuzz(workdir, trials: int = 50, multiproc_trials: int = 2):
    """Phase 6e: ``blt_tpu_torch.tools.fuzz_e2e`` on the card in process
    (each engine and encoder leg against the oracle, and multi-process
    trials), then ``make_conformance``'s goldens reproduced by the CLI on
    the card. Returns the phase's launches by kernel."""
    from blt_tpu_torch import cli
    from blt_tpu_torch.tools import fuzz_e2e, make_conformance

    saved = os.environ.get("BLT_DEVICE_BATCH_BYTES")
    reset_all_launches()
    t0 = time.perf_counter()
    try:
        rc = fuzz_e2e.main(["--trials", str(trials), "--max-bytes", "200000",
                            "--multiproc-trials", str(multiproc_trials)])
    finally:  # the fuzzer's small device batches stay out of later phases
        if saved is None:
            os.environ.pop("BLT_DEVICE_BATCH_BYTES", None)
        else:
            os.environ["BLT_DEVICE_BATCH_BYTES"] = saved
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    # the engines' fused K2, the flat encoder's K2 slots, the K3 loop (K1
    # runs only in a trial whose table is empty, about one in forty)
    missing = [k for k in ("flat_bpe_packed", "flat_bpe", "token_pass_gap")
               if not launches.get(k)]
    if rc != 0 or missing:
        fail(f"fuzz: rc {rc}, kernels never launched {missing} (launches {launches})")
    emit({"phase": "fuzz", "trials": trials, "multiproc_trials": multiproc_trials,
          "max_bytes": 200000, "seconds": seconds, "launches": launches})

    conf = os.path.join(workdir, "conformance")
    if make_conformance.main([conf]) != 0:
        fail("make_conformance failed")
    reset_all_launches()
    t0 = time.perf_counter()
    out = os.path.join(conf, "out.bin")
    for golden, flags in GOLDENS.items():
        flags = [os.path.join(conf, f) if f == "merges.txt" else f for f in flags]
        if cli.main(["-i", os.path.join(conf, "input.bin"), "-o", out,
                     "--engine", "torch", *flags]) != 0:
            fail(f"{golden}: cli.main failed")
        with open(out, "rb") as f, open(os.path.join(conf, golden), "rb") as g:
            if f.read() != g.read():
                fail(f"{golden}: the CLI's output differs")
    for k, v in all_launches().items():
        launches[k] = launches.get(k, 0) + v
    emit({"phase": "conformance", "goldens": list(GOLDENS), "equal": True,
          "seconds": time.perf_counter() - t0})
    shutil.rmtree(conf)
    return launches


# the card tests' rules for T6's segment cases: (a, b) and (a, a) rules,
# (x, a) none
SEGMENT_MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259, (255, 255): 0xFFFF}
# kernel rows of the device-rate path: name -> (CUDA source, the Pallas
# function it replaces, its file); phase 7 gives their numbers
MEASURED_ROWS = {
    "basic_chained": ("chain.cu", "basic_encode_chained", "blt_tpu/ops/bpe_pallas.py"),
    "chain_copy": ("chain.cu", "_call", "tools/exp_chain.py"),
    "chain_widen": ("chain.cu", "_call", "tools/exp_chain.py"),
    "copy_sweep": ("chain.cu", "copy_pallas", "tools/exp_sweep.py"),
    **{f"parts_{v}": ("flat_bpe.cu", "chain.call", "tools/exp_parts.py")
       for v in ("emit", "noscan", "nolookup", "full")},
    "subgather": ("subgather.cu", "subgather", "tools/exp_parts.py"),
    "subgather_direct": ("subgather.cu", "subgather", "tools/exp_parts.py"),
    **{f"op_mix_{d}": ("op_mix.cu", "chain.call", "tools/exp_pack.py")
       for d in ("int32", "int16", "int8")},
    **{f"token_parts_{v}": ("token_pass.cu", "_one_call", "tools/exp_mp_ablate.py")
       for v in ("full", "noscan", "nolookup", "noshift")},
    "token_parts_copy": ("token_parts.cu", "_one_call", "tools/exp_mp_ablate.py"),
    **{f"scan_parts_{v}": ("flat_bpe.cu", "_pallas", "tools/exp_scan.py")
       for v in ("full", "noscan", "nolookup", "noshifts")},
    **{f"scan_parts_{v}": ("scan_parts.cu", "_pallas", "tools/exp_scan.py")
       for v in ("scan16", "swarpack")},
    **{f"opt_{v}": ("flat_bpe.cu", "chain.call", "tools/exp_opt.py")
       for v in ("base", "p2", "hoist", "swap")},
    "chd_prod": ("flat_bpe.cu", "chain.call", "tools/exp_chd.py"),
    "chd_novalid": ("flat_bpe.cu", "chain.call", "tools/exp_chd.py"),
    "chd_noscan2": ("scan_parts.cu", "chain.call", "tools/exp_chd.py"),
    **{f"bf16scan_{v}": ("scan_parts.cu", "chain", "tools/exp_bf16scan.py")
       for v in ("i32", "bf16")},
    **{f"gather_{v}": ("lookup.cu", "make_pallas", "tools/exp_gather.py")
       for v in ("chain", "g2d", "g2d_flat", "gax0", "g8bit")},
    **{f"gather_{v}": ("onehot_mma.cu", "make_pmxu.kernel", "tools/exp_gather.py")
       for v in ("pmxu_i8", "pmxu_bf16")},
    **{f"probe16_{b}": ("probe16.cu", body, "tools/exp_16bit.py")
       for b, body in (("bf16_roll", "k_bf16_roll"), ("bf16_max", "k_bf16_max"),
                       ("bf16_select", "k_bf16_select"), ("bf16_rowroll", "k_bf16_rowroll"),
                       ("i16_roll", "k_i16_roll"), ("bf16_scan7", "k_bf16_scan"))},
    **{f"canary_{b}": ("probe16.cu", f"run_canary.k_{b}", "tools/canary_16bit.py")
       for b in ("i16_roll", "strided_sublane")},
}
# T2's rows by the tool's variant names
OPT_ROWS = {"opt_base": "base", "opt_p2": "p2", "opt_hoist": "p2+hoist",
            "opt_swap": "p2+hoist+swap"}
# rows that are another row's flat pass, by (the tool whose run they read,
# the pass's counter): T4's full is K4, T6's and T10's prod K2, T2's base
# T8's full
COUNTED_AS = {"token_parts_full": ("exp_mp_ablate", "token_pass"),
              "scan_parts_full": ("exp_scan", "flat_bpe"),
              "opt_base": ("exp_opt", "parts_full"),
              "chd_prod": ("exp_chd", "flat_bpe")}
# the runs phase 7 makes: label -> (tool, size in bytes, chain length), each
# original's; T13 and T14 at the original's 4096 rows (2 MiB of p) and at
# 131072 (64 MiB, the other tools' size); T3 at its 512 rows and 64 MiB; T11
# at its 8 rows
TOOLS = {"exp_chain": ("exp_chain", 64 * MIB, 96), "exp_sweep": ("exp_sweep", 64 * MIB, 8),
         "exp_parts": ("exp_parts", 64 * MIB, 8), "exp_pack": ("exp_pack", 8 * MIB, 64),
         "exp_mp_ablate": ("exp_mp_ablate", 8 * MIB, 8),
         "exp_scan": ("exp_scan", 64 * MIB, 64), "exp_opt": ("exp_opt", 64 * MIB, 8),
         "exp_chd": ("exp_chd", 64 * MIB, 8), "exp_bf16scan": ("exp_bf16scan", 64 * MIB, 64),
         "exp_gather_4096": ("exp_gather", 2 * MIB, 16),
         "exp_gather": ("exp_gather", 64 * MIB, 16),
         "exp_16bit": ("exp_16bit", 64 * MIB, 16), "canary_16bit": ("canary_16bit", 8 * 512, 16),
         "exp_lookback": ("exp_lookback", 64 * MIB, 8),
         # the glue-only timing tools of the multipass loop, the engine and the
         # 50k table (their k: warm calls, samples, the K3 chain, calls a
         # sample, calls a sample, timed runs, chain, chain)
         "exp_multipass": ("exp_multipass", 16 * MIB, 1), "exp_mp": ("exp_mp", 4 * MIB, 1),
         "exp_gap": ("exp_gap", 16 * MIB, 8), "exp_gapvar": ("exp_gapvar", 8 * MIB, 2),
         "exp_compact": ("exp_compact", 8 * MIB, 3), "exp_e2e": ("exp_e2e", 100 * MIB, 1),
         "exp_dense": ("exp_dense", 64 * MIB, 8), "exp_occ": ("exp_occ", 64 * MIB, 8)}
# the three-launch designs the main path no longer runs (K2, its pack, K4):
# their launches are phase 7's (exp_lookback, exp_mp_ablate, exp_chain, ...)
OFF_PATH = ("flat_bpe", "pack_slots", "token_pass")
# a tool's figures beside its rows, printed with them
MEASURE_KEYS = ("split", "ratio", "exact_prefix", "rounds", "host_compaction_mb_s",
                "device_resident_mb_s", "device_compute_only_mb_s", "expand_host_ms",
                "tombstones", "small_run", "small_link")
# tools whose size option is rows of 128 int32 in place of --size-mib
ROWS_OPTION = ("exp_gather", "canary_16bit")
# the most bytes a tool is given as a process (phase 7(c)): that run checks
# the entry point, the in-process run (b) measures at the original's size
PROCESS_BYTES = 8 * MIB
# the tools' processes that run at once in phase 7(c): their figures are
# not kept, and each one's start (the import, the card) dominates its time
PROCESSES_AT_ONCE = 4
# a tool's other arguments as a process (its batches within PROCESS_BYTES)
PROCESS_ARGS = {"exp_e2e": ["--batches-mb", "4,2"]}


def _summary(row: dict) -> dict:
    """A tool's row, short: ms per launch (median, IQR) and GB/s (median)
    as launched and replayed from a graph, beside bound, plain and clone;
    a row timed by the wall clock, ms a call (median, IQR) and MB/s
    (median, IQR) beside its bound."""
    out = {k: row[k] for k in ("name", "kernel", "route", "rpb", "blocks", "dtype", "idx_range",
                               "p_rows", "x_rows", "tile", "k", "rules", "first_bytes",
                               "occupied_first_bytes", "rounds", "batch_bytes", "stage_stats",
                               "exact") if k in row}
    if "wall" in row:
        t = row["wall"]
        return {**out, "ms": t["ms"]["median"], "iqr_ms": t["ms"]["iqr"],
                "MB_per_s": t["MB_per_s"]["median"], "iqr_MB_per_s": t["MB_per_s"]["iqr"],
                "n": t["ms"]["n"], "bound_ms": row["bound_ms"]}
    for mode in ("eager", "graph"):
        t = row[mode]
        out[mode] = {"ms": t["ms_per_launch"]["median"], "iqr_ms": t["ms_per_launch"]["iqr"],
                     "GB_per_s": t["GB_per_s"]["median"]}
    return {**out, "bound_ms": row["bound_ms"], "bound_by": row.get("bound_by", "bytes"),
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"]}


def _label(row: dict) -> str:
    """A tool's row by its name and the fields that tell its rows apart."""
    return "/".join(str(row[k]) for k in ("name", "rpb", "dtype", "idx_range", "x_rows", "rules")
                    if row.get(k) is not None)


def phase_measure(corpus, flat_cases, token_cases, err):
    """Phase 7: the device-rate path. (a) each new kernel against its plain
    version; (b) the tools' measurements in process at the originals'
    sizes, the launch counters set to 0 before and read after; (c) each
    tool as a process."""
    import numpy as np
    import torch

    from blt_tpu_torch.ops import bpe_cuda, multipass_cuda, tools_cuda
    from blt_tpu_torch.tools import (
        canary_16bit,
        exp_16bit,
        exp_bf16scan,
        exp_chain,
        exp_chd,
        exp_compact,
        exp_dense,
        exp_e2e,
        exp_gather,
        exp_gapvar,
        exp_lookback,
        exp_mp,
        exp_mp_ablate,
        exp_multipass,
        exp_occ,
        exp_opt,
        exp_pack,
        exp_parts,
        exp_scan,
        exp_sweep,
    )

    from blt_tpu_torch.merges import MergeTable
    from blt_tpu_torch.ops.tables import wire_table
    from blt_tpu_torch.tools._common import time_chain

    dev = torch.device("cuda", 0)
    for k in MEASURED_ROWS:
        err[k] = 0
    cases = 0

    def hold(name, got, ref, what):
        nonlocal cases
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, ref = (got,), (ref,)
        e = max(int_err(a, b) for a, b in zip(got, ref, strict=True))
        if e:
            fail(f"{name}, {what}: err {e}")
        err[name] = max(err[name], e)
        cases += 1

    # (a) exactness
    data2 = torch.from_numpy(np.ascontiguousarray(corpus[: 16 * MIB])).to(dev).reshape(-1, 128)
    tok = torch.tensor([[1000]], dtype=torch.int32, device=dev)
    for k in (1, 3):
        hold("basic_chained", bpe_cuda.basic_encode_chained(data2, tok, k, 2048),
             bpe_cuda.basic_chained_plain(data2, tok, k, 2048), f"k={k}")
        hold("chain_copy", exp_chain.copy_chain(data2, tok, 2048, k),
             exp_chain.copy_chain_plain(data2, tok, 2048, k), f"k={k}")
        hold("chain_widen", exp_chain.widen_chain(data2, tok, 2048, k),
             exp_chain.widen_chain_plain(data2, tok, 2048, k), f"k={k}")
    for rpb in (1, 8, *exp_sweep.RPBS):
        hold("copy_sweep", exp_sweep.copy_pallas(data2, rpb),
             exp_sweep.copy_plain(data2, rpb), f"rpb={rpb}")
    # the copy ring's ragged edges: one row, a span of one stage + 128 B (a
    # short last stage), 64 MiB + 128 B over T1's persistent grid; T7 over
    # one grid step at each rpb, and over three steps of one stage + 128 B
    stage_rows = bpe_cuda.RING_STAGE_BYTES // 128 + 1
    big = torch.from_numpy(np.ascontiguousarray(corpus[: 64 * MIB + 128])).to(dev).reshape(-1, 128)
    for rows in (1, stage_rows, big.shape[0]):
        for k in (1, 3):
            hold("chain_copy", exp_chain.copy_chain(big[:rows], tok, 1, k),
                 exp_chain.copy_chain_plain(big[:rows], tok, 1, k), f"{rows} rows k={k}")
    for rpb, steps in ((1, 1), (8, 1), (512, 1), (2048, 1), (8192, 1), (stage_rows, 3)):
        hold("copy_sweep", exp_sweep.copy_pallas(big[: rpb * steps], rpb),
             exp_sweep.copy_plain(big[: rpb * steps], rpb), f"{steps} steps of rpb={rpb}")
    del big
    for data, n, nb, table, carry in flat_cases:
        c = torch.tensor([[carry]], dtype=torch.int32, device=dev)
        what = f"n={n} next_byte={nb} carry={carry}"
        for v in exp_parts.VARIANTS:
            hold(f"parts_{v}", exp_parts.flat_parts(v, data, n, nb, table, c),
                 exp_parts.flat_parts_plain(v, data, n, nb, table, c), what)
        # full is K2's slot with each merge start's value byteswapped
        full, full_c = exp_parts.flat_parts("full", data, n, nb, table, c)
        k2, k2_c = bpe_cuda.flat_encode_slots(data, n, nb, table, c)
        k2_32 = k2.to(torch.int32)
        swapped = torch.where((k2_32 & 0xFF) != 0, ((k2_32 & 0xFF) << 8) | (k2_32 >> 8), k2_32)
        hold("parts_full", (full.to(torch.int32), full_c), (swapped, k2_c), f"{what}, vs K2")
        # T6; the block-local variants at each rows_per_block that tiles the batch
        for v, flags in exp_scan.VARIANTS.items():
            local = flags is None
            for rpb in (8, 16, 1024) if local else (exp_scan.RPB,):
                if local and data.numel() % (rpb * 128):
                    continue
                hold(f"scan_parts_{v}", exp_scan.scan_parts(v, data, n, nb, table, c, rpb),
                     exp_scan.scan_parts_plain(v, data, n, nb, table, c, rpb),
                     f"{what} rpb={rpb}")
        hold("scan_parts_full", exp_scan.scan_parts("full", data, n, nb, table, c), (k2, k2_c),
             f"{what}, vs K2")
        # T2: each variant is K2 with its starts byteswapped
        for name, v in OPT_ROWS.items():
            vt = exp_opt.variant_table(v, table)
            got = exp_opt.opt_pass(v, data, n, nb, vt, c)
            hold(name, got, exp_opt.opt_pass_plain(v, data, n, nb, vt, c), what)
            hold(name, (got[0].to(torch.int32), got[1]), (swapped, k2_c), f"{what}, vs K2")
        # T10; noscan2 at each rows_per_block that tiles the batch
        hold("chd_prod", exp_chd.chd_pass("prod", data, n, nb, table, c), (k2, k2_c),
             f"{what}, vs K2")
        hold("chd_novalid", exp_chd.chd_pass("novalid", data, n, nb, table, c),
             exp_chd.chd_pass_plain("novalid", data, n, nb, table, c), what)
        for rpb in (8, 16, 1024):
            if data.numel() % (rpb * 128) == 0:
                hold("chd_noscan2", exp_chd.chd_pass("noscan2", data, n, nb, table, c, rpb),
                     exp_chd.chd_pass_plain("noscan2", data, n, nb, table, c, rpb),
                     f"{what} rpb={rpb}")
    # T6's scan16 and swarpack, and T10's noscan2, on the card tests'
    # segment cases: rpb 8, 16 and 1024; n at the capacity, 3001 and 1;
    # carry 0 and 1; next_byte -1 and 98; buffers whose every segment ends
    # in a start (its last row all (a, a) after (x, a) at an even position,
    # its last pair (a, b) a rule: in swarpack too) and an all-match run
    # (noscan2's worst case: every block's carry depends on the one
    # before); then chains of 4 replayed from a CUDA graph
    seg_table = wire_table(MergeTable.build(SEGMENT_MERGES).dense, dev)
    seg_rng = np.random.default_rng(30)
    for rpb in (8, 16, 1024):
        seg = rpb * 128
        text = seg_rng.choice(np.frombuffer(b"aabbcc \xffab\x00hpx", np.uint8),
                              (64 if rpb < 1024 else 3) * seg).astype(np.uint8)
        for s0 in range(seg, text.size, seg):
            text[s0 - 130] = ord("x")
            text[s0 - 129 : s0] = ord("a")
            text[s0] = ord("b")
        for name, buf in (("segments end in starts", text),
                          ("all match", np.full(3 * seg, 97, np.uint8))):
            d = torch.from_numpy(buf).to(dev)
            for n, carry, nb in itertools.product((d.numel(), 3001, 1), (0, 1), (-1, 98)):
                c = torch.tensor([[carry]], dtype=torch.int32, device=dev)
                what = f"{name}, rpb={rpb} n={n} carry={carry} next_byte={nb}"
                for v in tools_cuda.BLOCK_SCANS:
                    hold(f"scan_parts_{v}", tools_cuda.block_scan(v, d, n, nb, seg_table, c, rpb),
                         tools_cuda.block_scan_plain(v, d, n, nb, seg_table, c, rpb), what)
                hold("chd_noscan2", tools_cuda.row_scan(d, n, nb, seg_table, c, rpb),
                     tools_cuda.row_scan_plain(d, n, nb, seg_table, c, rpb), what)
        # noscan2's look-back over identity maps with constants among them:
        # 512 blocks all match but for a space in the last row of every
        # fifth, so a carry found far back is overridden by a nearer map
        mixed = np.full(512 * seg, 97, np.uint8)
        mixed[np.arange(2, 512, 5) * seg + seg - 88] = 32
        d = torch.from_numpy(mixed).to(dev)
        for carry in (0, 1):
            c = torch.tensor([[carry]], dtype=torch.int32, device=dev)
            hold("chd_noscan2", tools_cuda.row_scan(d, d.numel(), -1, seg_table, c, rpb),
                 tools_cuda.row_scan_plain(d, d.numel(), -1, seg_table, c, rpb),
                 f"identity and constant maps, rpb={rpb} carry={carry}")
        d = torch.from_numpy(text[: 16 * seg]).to(dev)
        c = torch.ones((1, 1), dtype=torch.int32, device=dev)
        for v in tools_cuda.BLOCK_SCANS:
            expect = exp_scan.chain_plain(v, d, d.numel() - 3, 98, seg_table, c, 4, rpb)
            replay = time_chain(lambda v=v: exp_scan.chain(v, d, d.numel() - 3, 98, seg_table, c,
                                                           4, rpb), 4, d.numel(), dev, expect)
            if not replay["exact"] or replay["graph"] is None:
                fail(f"scan_parts_{v}: a chain of 4 at rpb {rpb} does not replay exactly")
            hold(f"scan_parts_{v}", exp_scan.chain(v, d, d.numel() - 3, 98, seg_table, c, 4, rpb),
                 expect, f"rpb={rpb} chained 4")
        expect = bpe_cuda.chain_passes(lambda c: exp_chd.chd_pass_plain(
            "noscan2", d, d.numel() - 3, 98, seg_table, c, rpb), c, 4)
        replay = time_chain(lambda: exp_chd.chain("noscan2", d, d.numel() - 3, 98, seg_table, c,
                                                  4, rpb), 4, d.numel(), dev, expect)
        if not replay["exact"] or replay["graph"] is None:
            fail(f"chd_noscan2: a chain of 4 at rpb {rpb} does not replay exactly")
        hold("chd_noscan2", exp_chd.chain("noscan2", d, d.numel() - 3, 98, seg_table, c, 4, rpb),
             expect, f"rpb={rpb} chained 4")
    # T9: in-block, +-2 rpb and full-int32 indices on two blocks or 16 MiB;
    # the slab path at 8 columns (rpb 8, 16, 1024, 2048) and 4 (4096); past
    # one CTA's slab the direct path (7240: some CTAs' spans of 16 rows
    # cross a block's end; 10000 and 16384)
    rng = np.random.default_rng(9)
    for rpb in (8, 16, 1024, 2048, 4096, 7240, 10000, exp_parts.SUBGATHER_DIRECT_RPB):
        rows = max(2 * rpb, 16 * MIB // 512 // rpb * rpb)
        tbl = torch.from_numpy(rng.integers(0, 1 << 30, (rows, 128), dtype=np.int32)).to(dev)
        name = tools_cuda.subgather_plan(rows, rpb)["kernel"]
        for lo, hi in ((0, rpb), (-2 * rpb, 2 * rpb), (-(2**31), 2**31 - 1)):
            idx = torch.from_numpy(
                rng.integers(lo, hi, (rows, 128), dtype=np.int64).astype(np.int32)).to(dev)
            hold(name, tools_cuda.subgather(tbl, idx, rpb),
                 tools_cuda.subgather_plain(tbl, idx, rpb), f"rpb={rpb} idx in [{lo}, {hi})")
        del tbl, idx
    # T5: each type over its whole range, so the multiply and the add wrap
    for name in tools_cuda.MIX_DTYPES:
        info = np.iinfo(name)
        x = torch.from_numpy(rng.integers(info.min, info.max + 1, (16384, 128), dtype=np.int64)
                             .astype(name)).to(dev)
        for k in (1, 3):
            hold(f"op_mix_{name}", tools_cuda.op_mix(x, tok, k), tools_cuda.op_mix_plain(x, tok, k),
                 f"k={k}")
        # the edge rows of the packed words: min, max, -1, 0 at lanes 0, 1,
        # 2, 127 and beside every word and vector boundary; rows whose
        # select fires
        x = torch.from_numpy(exp_pack.edge_rows(name, 16384, seed=len(name))).to(dev)
        for k in (1, 3, 64):
            hold(f"op_mix_{name}", tools_cuda.op_mix(x, tok, k), tools_cuda.op_mix_plain(x, tok, k),
                 f"edge rows, k={k}")
    # T4: phase 3's token-pass cases, chained three times through tombstones
    for t, n, planes in token_cases:
        what = f"{t.numel()} tokens, n={n}"
        for v in exp_mp_ablate.VARIANTS:
            hold(f"token_parts_{v}", exp_mp_ablate.chain(v, t, n, planes, 3),
                 exp_mp_ablate.chain_plain(v, t, n, planes, 3), what)
        hold("token_parts_full", exp_mp_ablate.token_parts("full", t, n, planes),
             multipass_cuda.token_pass(t, n, planes), f"{what}, vs K4")
    # T12: single links on random masks of 16 MiB (whole segments: rpb 24's
    # and 1016's leave the last tile partial), and chains fed back as the
    # tool's; then a chain of 4 replayed from a CUDA graph
    for density in (0.0, 0.3, 0.7, 1.0):
        full = exp_bf16scan.random_mask(rng, 16 * MIB // 128, density)
        for rpb in (8, 24, 1016, 1024):
            mask = torch.from_numpy(full[: full.shape[0] // rpb * rpb]).to(dev)
            for v in tools_cuda.MASK_SCANS:
                what = f"density {density} rpb={rpb}"
                hold(f"bf16scan_{v}", tools_cuda.mask_scan(v, mask, rpb),
                     tools_cuda.mask_scan_plain(mask, rpb), what)
                for k in (1, 3):
                    hold(f"bf16scan_{v}", exp_bf16scan.chain(v, mask, k, rpb),
                         exp_bf16scan.chain_plain(mask, k, rpb), f"{what} k={k}")
    mask = torch.from_numpy(exp_bf16scan.random_mask(rng, 24 * 5000, 0.3)).to(dev)
    for v in tools_cuda.MASK_SCANS:
        expect = exp_bf16scan.chain_plain(mask, 4, 24)
        replay = time_chain(lambda v=v: (exp_bf16scan.chain(v, mask, 4, 24),), 4, mask.numel(),
                            dev, (expect,))
        if not replay["exact"] or replay["graph"] is None:
            fail(f"bf16scan_{v}: a chain of 4 at rpb 24 does not replay exactly")
    # T13: p inside and outside the tool's domain [0, 65536), 16 MiB of each
    val16, packed = exp_gather.build_table()
    tables = {"packed": torch.from_numpy(packed).to(dev),
              "tbl8": torch.from_numpy(exp_gather.build_tbl8()).to(dev)}
    for lo, hi in ((0, 65536), (-(2**31), 2**31 - 1)):
        p = torch.from_numpy(rng.integers(lo, hi, (16 * MIB // 512, 128), dtype=np.int64)
                             .astype(np.int32)).to(dev)
        for v in tools_cuda.LOOKUPS:
            tbl = tables["tbl8" if v == "g8bit" else "packed"]
            what = f"p in [{lo}, {hi})"
            hold(f"gather_{v}", tools_cuda.lookup(v, tbl, p), tools_cuda.lookup_plain(v, tbl, p),
                 what)
            hold(f"gather_{v}", exp_gather.chained(v, tbl, p, 3),
                 exp_gather.chained_plain(v, tbl, p, 3), f"{what} k=3")
    # T13's five lookups at the card tests' 1000 and 4096 rows (32 and 128
    # CTAs of 4 Ki elements, 16 and 64 of g2d_flat's 8 Ki), and each one's
    # chain of 4 replayed from a CUDA graph
    for rows, (lo, hi) in itertools.product((1000, 4096), ((0, 65536), (-(2**31), 2**31 - 1))):
        p = torch.from_numpy(rng.integers(lo, hi, (rows, 128), dtype=np.int64)
                             .astype(np.int32)).to(dev)
        for v in tools_cuda.LOOKUPS:
            tbl = tables["tbl8" if v == "g8bit" else "packed"]
            what = f"{rows} rows, p in [{lo}, {hi})"
            hold(f"gather_{v}", tools_cuda.lookup(v, tbl, p), tools_cuda.lookup_plain(v, tbl, p),
                 what)
            hold(f"gather_{v}", exp_gather.chained(v, tbl, p, 3),
                 exp_gather.chained_plain(v, tbl, p, 3), f"{what} k=3")
    p = torch.from_numpy(rng.integers(0, 65536, (4096, 128)).astype(np.int32)).to(dev)
    for v in tools_cuda.LOOKUPS:
        tbl = tables["tbl8" if v == "g8bit" else "packed"]
        expect = exp_gather.chained_plain(v, tbl, p, 4)
        replay = time_chain(lambda v=v, tbl=tbl: (exp_gather.chained(v, tbl, p, 4),), 4,
                            4 * p.numel(), dev, (expect,))
        if not replay["exact"] or replay["graph"] is None:
            fail(f"gather_{v}: a chain of 4 does not replay exactly")
    # T14: the same two ranges over 1.5 Mi positions (two pieces of the plain
    # version), once and chained 3 times, at tiles 512, 48, 16 and 80 (all but
    # 512 end inside a 64-row warpgroup tile, whose rows past the tile are
    # masked), and over 68096 positions at tile 512: 133 tiles, one more
    # than the SMs
    planes = {d: tools_cuda.mxu_planes(val16, d).to(dev) for d in tools_cuda.MXU_DTYPES}
    for (lo, hi), (rows, tiles) in itertools.product(
            ((0, 65536), (-(2**31), 2**31 - 1)), ((12240, (512, 48, 16, 80)), (532, (512,)))):
        p = torch.from_numpy(rng.integers(lo, hi, (rows, 128), dtype=np.int64)
                             .astype(np.int32)).to(dev)
        for dtype, (name, _, _) in tools_cuda.MXU_DTYPES.items():
            for tile in tiles:
                what = f"p in [{lo}, {hi}) rows={rows} tile={tile}"
                hold(f"gather_{name}", tools_cuda.pmxu(dtype, planes[dtype], p, tile=tile),
                     tools_cuda.pmxu_plain(dtype, planes[dtype], p, tile=tile), what)
                hold(f"gather_{name}", exp_gather.chained_mxu(dtype, planes[dtype], p, 3, tile),
                     exp_gather.chained_mxu(dtype, planes[dtype], p, 3, tile, plain=True),
                     f"{what} k=3")
    # T3 and T11: the originals' x and random |x| < 2**30, at 512, 8, 13 and
    # 513 rows (rows that leave a warp's or a CTA's rows partial) and 131072
    for rows in (512, 8, 13, 513, 131072):
        rand = rng.integers(-(2**30) + 1, 2**30, (rows, 128), dtype=np.int64).astype(np.int32)
        for name, x in (("arange % 97", exp_16bit.original_x(rows)),
                        ("random", torch.from_numpy(rand))):
            x = x.to(dev)
            for probe in tools_cuda.PROBES16:
                hold(probe, tools_cuda.probe16(probe, x), tools_cuda.probe16_plain(probe, x),
                     f"{name}, {rows} rows")
    emit({"phase": "measure_exact", "cases": cases, "tolerance": 0,
          "max_abs_err": {k: err[k] for k in MEASURED_ROWS}})

    # (b) the rates at the originals' sizes, in this process
    modules = {"exp_chain": exp_chain, "exp_sweep": exp_sweep, "exp_parts": exp_parts,
               "exp_pack": exp_pack, "exp_mp_ablate": exp_mp_ablate, "exp_scan": exp_scan,
               "exp_opt": exp_opt, "exp_chd": exp_chd, "exp_bf16scan": exp_bf16scan,
               "exp_gather": exp_gather, "exp_16bit": exp_16bit, "canary_16bit": canary_16bit,
               "exp_lookback": exp_lookback, "exp_multipass": exp_multipass, "exp_mp": exp_mp,
               "exp_gap": exp_gap, "exp_gapvar": exp_gapvar, "exp_compact": exp_compact,
               "exp_e2e": exp_e2e, "exp_dense": exp_dense, "exp_occ": exp_occ}
    reset_all_launches()
    results, during = {}, {}
    for name, (tool, size, k) in TOOLS.items():
        t0 = time.perf_counter()
        before = all_launches()
        results[name] = modules[tool].measure(dev, size, k=k)
        during[name] = {c: n - before[c] for c, n in all_launches().items()}
        if not results[name]["exact"]:
            fail(f"{name}: a kernel differs from its plain version")
        emit({"phase": "measure", "tool": name, "size_bytes": size,
              "seconds": time.perf_counter() - t0,
              "rows": [_summary(r) for r in results[name]["rows"]],
              **{key: results[name][key] for key in MEASURE_KEYS if key in results[name]}})
    launches = {**all_launches(),
                **{row: during[tool][c] for row, (tool, c) in COUNTED_AS.items()}}
    missing = [k for k in (*MEASURED_ROWS, *OFF_PATH) if not launches[k]]
    if missing:
        fail(f"kernels of the device-rate path never launched: {missing}")

    # (c) the entry points as processes, at most PROCESS_BYTES each, a few at
    # once (a process's start dominates): (b) measured every tool at its
    # original's size, alone
    import concurrent.futures

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")

    def run_tool(tool, size_bytes):
        size_bytes = min(size_bytes, PROCESS_BYTES)
        size = ["--rows", str(size_bytes // 512)] if tool in ROWS_OPTION else [
            "--size-mib", str(size_bytes // MIB)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"blt_tpu_torch.tools.{tool}", *size,
             *PROCESS_ARGS.get(tool, [])],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
        )
        return proc, time.perf_counter() - t0

    t_all = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(PROCESSES_AT_ONCE) as pool:
        # one process per tool
        runs = [(name, pool.submit(run_tool, tool, size_bytes))
                for name, (tool, size_bytes, _) in TOOLS.items() if name == tool]
        for name, job in runs:
            proc, seconds = job.result()
            if proc.returncode != 0:
                fail(f"{name} exited {proc.returncode}: {proc.stderr[-2000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            if not out["exact"] or out["device"]["type"] != "cuda":
                fail(f"{name} as a process: exact {out['exact']}, device {out['device']}")
            emit({"phase": "measure_process", "tool": name, "rc": 0, "seconds": seconds,
                  "graph_ms": {_label(r): r["graph"]["ms_per_launch"]["median"]
                               for r in out["rows"] if "graph" in r},
                  "wall_ms": {_label(r): r["wall"]["ms"]["median"]
                              for r in out["rows"] if "wall" in r}})
    emit({"phase": "measure_processes", "processes": len(runs), "at_once": PROCESSES_AT_ONCE,
          "seconds": time.perf_counter() - t_all})

    def row(tool, name, **want):
        return next(r for r in results[tool]["rows"]
                    if r["name"] == name and all(r.get(k) == v for k, v in want.items()))

    rows = {"basic_chained": row("exp_chain", "basic_chained", rpb=2048),
            "chain_copy": row("exp_chain", "copy", rpb=2048),
            "chain_widen": row("exp_chain", "widen", rpb=2048),
            "copy_sweep": row("exp_sweep", "copy", rpb=2048),
            **{f"parts_{v}": row("exp_parts", v) for v in exp_parts.VARIANTS},
            "subgather": row("exp_parts", "subgather", idx_range=exp_parts.SUBGATHER_RPB),
            "subgather_direct": row("exp_parts", "subgather",
                                    rpb=exp_parts.SUBGATHER_DIRECT_RPB),
            **{f"op_mix_{d}": row("exp_pack", "op_mix", dtype=d) for d in tools_cuda.MIX_DTYPES},
            **{f"token_parts_{v}": row("exp_mp_ablate", v, rpb=512)
               for v in exp_mp_ablate.VARIANTS},
            **{f"scan_parts_{v}": row("exp_scan", v) for v in exp_scan.VARIANTS},
            **{name: row("exp_opt", v) for name, v in OPT_ROWS.items()},
            "chd_prod": row("exp_chd", "prod", rpb=exp_chd.RPB),
            **{f"chd_{v}": row("exp_chd", v) for v in ("novalid", "noscan2")},
            **{f"bf16scan_{v}": row("exp_bf16scan", v) for v in tools_cuda.MASK_SCANS},
            **{f"gather_{v}": row("exp_gather", v)
               for v in tools_cuda.LOOKUPS + tools_cuda.MXU_LOOKUPS},
            **{p: row("exp_16bit", p.split("_", 1)[1], x_rows=TOOLS["exp_16bit"][1] // 512)
               for p in exp_16bit.PROBES},
            **{p: row("canary_16bit", p.split("_", 1)[1])
               for p in ("canary_i16_roll", "canary_strided_sublane")}}
    return {"launches": {k: launches[k] for k in (*MEASURED_ROWS, *OFF_PATH)}, "rows": rows,
            "exp_lookback": results["exp_lookback"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size-mib", type=int, default=1024,
                    help="corpus size of the main-path legs (default 1 GiB)")
    args = ap.parse_args()

    # 1. device
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from blt_tpu_torch.ops import _cuda_build

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build; T14's kernels must hold wgmma (IGMMA int8, HGMMA bf16), the
    # copy ring bulk copies (UBLKCP), T9's slab kernels TMA loads (UTMALDG)
    t0 = time.perf_counter()
    lib = _cuda_build.build()
    _cuda_build.load()
    seconds = time.perf_counter() - t0
    sass = _cuda_build.sass_counts("pmxu_kernel", ("HGMMA", "IGMMA"))
    if sass is not None and (len(sass) != 2 or not all(sum(c.values()) for c in sass.values())):
        fail(f"T14's kernels hold no wgmma: {sass}")
    ring_sass = _cuda_build.sass_counts("copy_ring_kernel", ("UBLKCP",))
    if ring_sass is not None and (len(ring_sass) != 1
                                  or not all(c["UBLKCP"] for c in ring_sass.values())):
        fail(f"the copy ring holds no bulk copy: {ring_sass}")
    # T9's slab kernels (one per width) stage their rows by TMA
    slab_sass = _cuda_build.sass_counts("subgather_slab_kernel", ("UTMALDG", "UBLKCP"))
    if slab_sass is not None and (len(slab_sass) != 2
                                  or not all(sum(c.values()) for c in slab_sass.values())):
        fail(f"T9's slab kernels hold no TMA load: {slab_sass}")
    # T13's lookups that stage a table (chain, whose instantiation g2d runs,
    # gax0 and g8bit: lookup_kernel<0, 3, 4>), T6's scan16 and swarpack their
    # tiles, by bulk copies
    lookup_sass = _cuda_build.sass_counts("13lookup_kernel", ("UBLKCP",)) or {}
    staged_sass = {**{k: c for k, c in lookup_sass.items() if "ILi2E" not in k},
                   **(_cuda_build.sass_counts("segment_scan", ("UBLKCP",)) or {})}
    if ring_sass is not None and (len(staged_sass) != 5
                                  or not all(c["UBLKCP"] for c in staged_sass.values())):
        fail(f"T13's staged lookups or T6's segment scans hold no bulk copy: {staged_sass}")
    # T5's int16 and int8 kernels: every opcode, for the instructions a word takes
    mix_sass = _cuda_build.sass_counts("op_mix_packed_kernel", None)
    if mix_sass is not None and len(mix_sass) != 2:
        fail(f"op_mix.cu holds {len(mix_sass)} packed kernels")
    emit({"phase": "build", "seconds": seconds,
          "compiled": _cuda_build.build_seconds is not None,
          "library": os.path.relpath(lib, ROOT),
          "onehot_mma": {"ptxas": _cuda_build.kernel_resources("onehot_mma"), "sass": sass},
          "chain": {"ptxas": _cuda_build.kernel_resources("chain"), "sass": ring_sass},
          "subgather": {"ptxas": _cuda_build.kernel_resources("subgather"), "sass": slab_sass},
          "token_pass_gap": {"ptxas": _cuda_build.kernel_resources("token_pass_gap")},
          "look_back_kernels": kernel_figures(LOOK_BACK_KERNELS),
          "redesigned_tool_kernels": {"resources": kernel_figures(REDESIGNED_TOOL_KERNELS),
                                      "sass": staged_sass, "op_mix_sass": mix_sass}})

    rng = np.random.default_rng(args.seed)
    corpus = make_corpus(rng, max(args.size_mib, 256) * MIB)
    merges500 = frequent_pairs(corpus, 500)
    merges50k = fifty_k_pairs(rng, merges500)
    # leg 4's general table, placed on the host before the card sees it
    from blt_tpu_torch.merges import MergeTable

    t0 = time.perf_counter()
    rules = exp_gap.hierarchical_rules(corpus)
    table = MergeTable.build(rules)
    built = table.build_cuckoo32()
    if table.flat or built is None or built[0].shape[0] != 8192:
        fail(f"the {len(rules)}-rule table is flat or not placed at 8192 slots")
    emit({"phase": "table", "rules": len(rules), "flat": table.flat,
          "max_value": max(rules.values()), "cuckoo32_slots": built[0].shape[0],
          "seconds": time.perf_counter() - t0})

    # 3. kernels against their plain versions
    err, ms, bounds, flat_cases, library = phase_kernels(
        corpus,
        numbered(merges500),
        numbered(merges50k),
        rng,
    )
    *parts, token_cases = phase_multipass_kernels(corpus, rules, rng)
    for d, part in zip((err, ms, bounds), parts):
        d.update(part)

    # 4-6. the main path, in process and as a process
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        inp, m500, launches, flat_legs = phase_main_path(corpus, merges500, merges50k, workdir)
        multipass_launches, multipass_legs = phase_multipass(corpus, inp, rules, workdir)
        launches.update(multipass_launches)
        phase_process(inp, m500, merges500)
        # 6b. the sharded engine and the multi-process runner
        phase_shard(corpus, inp, workdir, flat_legs, multipass_legs, rules, merges500)
        # 6c. the HTTP server; its launches join the main path's
        for k, v in phase_serve(corpus, workdir, m500, merges500, merges50k, rules).items():
            launches[k] += v
        # 6d. training, and its table on the main path; 6e. the fuzzer and
        # the conformance goldens
        t0 = time.perf_counter()
        for k, v in phase_train(corpus, workdir, multipass_legs["multipass_sort"]["src"]).items():
            launches[k] += v
        emit({"phase": "train_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        for k, v in phase_fuzz(workdir).items():
            launches[k] += v
        emit({"phase": "fuzz_seconds", "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 7. the device-rate path
    measured = phase_measure(corpus, flat_cases, token_cases, err)
    # added, not replaced: K2's slot pass (flat_bpe) also runs in 6e
    for k, v in measured["launches"].items():
        launches[k] = launches.get(k, 0) + v
    # the standalone pack's time: chained through its last slot (a single
    # call's events time the host's launch)
    pack = next(r for r in measured["exp_lookback"]["rows"] if r["name"] == "pack")
    ms["pack_slots"] = (pack["graph"]["ms_per_launch"]["median"], pack["plain_ms"])
    bounds["pack_slots"] = pack["bound_ms"]

    # 8. nothing of JAX or the JAX package anywhere in this process
    bad = sorted(k for k in sys.modules if k == "blt_tpu" or k.startswith(("blt_tpu.", "jax")))
    if bad:
        fail(f"imported {bad}")
    emit({"phase": "no_jax", "jax_or_blt_tpu_in_sys_modules": False})

    rows = {  # name: (source, the Pallas function it replaces)
        "widen": ("widen.cu", "basic_encode_pallas"),
        "flat_bpe_packed": ("flat_bpe.cu", "_flat_encode_packed"),
        "flat_bpe": ("flat_bpe.cu", "_flat_encode_pallas_call"),
        "pack_slots": ("flat_bpe.cu", "_pack_slots_core"),
        "token_pass_gap": ("token_pass_gap.cu", "_token_pass_gap_call"),
        "token_pass_lookback": ("token_pass.cu", "_token_pass_call"),
        "token_pass": ("token_pass.cu", "_token_pass_call"),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": f"blt_tpu_torch/csrc/{src}",
         "replaces": pallas_line(func), "launches": launches[k],
         "max_abs_err": err[k], "ms": ms[k][0], "plain_ms": ms[k][1],
         "bound_ms": bounds[k], "bound_by": "bytes", "library_ms": library.get(k)}
        for k, (src, func) in rows.items()
    ]
    for k, (src, func, rel) in MEASURED_ROWS.items():
        r = measured["rows"][k]
        kernels.append({
            "name": k, "route": "cuda", "source": f"blt_tpu_torch/csrc/{src}",
            "replaces": pallas_line(func, rel), "launches": launches[k],
            "max_abs_err": err[k], "ms": r["graph"]["ms_per_launch"]["median"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"), "library_ms": r["library_ms"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
