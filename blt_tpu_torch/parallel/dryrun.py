"""Multi-device dry run (port of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``).

``dryrun_multichip(n)`` lays a tiny corpus out as n rows, runs every
sharded path on them and checks each bit for bit against the NumPy
engine's functions: the flat sharded step with its pair histogram, the
process split, the engine's basic and passthrough streams, the flat halo
stream with a degenerate batch, the general-table multipass through the
engine and both sharded encoder loops, and the decode assembly.

    python -m blt_tpu_torch.parallel.dryrun 4           # n rows on the CUDA devices
    python -m blt_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_numpy
from blt_tpu_torch.ops.decode import build_expansion_table, decode_wire
from blt_tpu_torch.ops.sharded_cuda import CudaShardedFlatEncoder, CudaShardedTokenEncoder
from blt_tpu_torch.parallel import multihost
from blt_tpu_torch.parallel.mesh import make_mesh, replicated, row_sharding
from blt_tpu_torch.parallel.sharded import pair_count_hist, sharded_flat_encode
from blt_tpu_torch.pipeline.engines import ShardedTorchEngine


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {what} mismatch")


def _wire(tokens) -> bytes:
    return np.asarray(tokens, np.int64).astype(">u2").tobytes()


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run and check every sharded path on ``n_devices`` rows. ``devices``:
    the rows' devices (default: the CUDA devices in turn; raises without
    one); ``[cpu] * n`` on the CPU."""
    if devices is None:
        cards = make_mesh()
        devices = [cards[i % len(cards)] for i in range(n_devices)]
    mesh = make_mesh(devices)
    if len(mesh) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(mesh)}")

    # B rows of N bytes, the last one short, heavy in merge pairs
    n = 2048
    b = n_devices
    rng = np.random.default_rng(1)
    merges = {(97, 98): 256, (98, 99): 257, (99, 97): 258}
    table = MergeTable.build(merges)
    corpus = rng.choice(np.frombuffer(b"abcabcaabbcc", np.uint8), size=b * n - n // 2).astype(
        np.uint8
    )
    batch = np.zeros((b, n), np.uint8)
    lengths = np.zeros(b, np.int32)
    for r in range(b):
        row = corpus[r * n : (r + 1) * n]
        batch[r, : row.shape[0]] = row
        lengths[r] = row.shape[0]
    rows = row_sharding(mesh, batch)
    tokens, counts, _ = sharded_flat_encode(rows, lengths, replicated(mesh, table.dense))
    got = np.concatenate([t[:c].cpu().numpy() for t, c in zip(tokens, counts.cpu().numpy())])
    expected = bpe_numpy.bpe_encode_flat(corpus, table)
    _check(got.tolist() == expected.tolist(), "sharded encode")
    hist = pair_count_hist(rows, lengths)
    _check(int(hist.sum()) == corpus.shape[0] - 1, "pair count")

    # the process split: bounds at merge-transparent positions reassemble
    # to the whole stream
    bounds = multihost.safe_split_bounds(corpus, table.dense, n_devices)
    parts = [bpe_numpy.bpe_encode_flat(corpus[bounds[i] : bounds[i + 1]], table)
             for i in range(n_devices) if bounds[i + 1] > bounds[i]]
    _check(np.concatenate(parts).tolist() == expected.tolist(), "process split")
    print(f"dryrun mode OK: flat-bpe sharded encode + process split ({n_devices} rows)")

    engine = ShardedTorchEngine(devices=mesh)
    _dryrun_engine_modes(engine, rng)
    _dryrun_flat_halo(engine, mesh)
    _dryrun_sharded_multipass(engine, mesh)
    _dryrun_distributed_decode(n_devices)
    print(
        f"dryrun_multichip OK: {n_devices} rows on {sorted({str(d) for d in mesh})}, "
        f"{corpus.shape[0]} bytes -> {got.shape[0]} tokens; modes: flat-bpe, flat-halo, "
        "basic, passthrough, multipass (engine, host and resident loops), decode-assembly"
    )


def _dryrun_engine_modes(engine, rng) -> None:
    """basic and passthrough through ShardedTorchEngine."""
    hint = 4096
    chunks = [rng.integers(0, 256, size=s, dtype=np.uint8) for s in (hint, 777, 1, hint, 50)]
    expected = np.concatenate(chunks)
    got = b"".join(bytes(x) for x in engine.basic_stream(iter(chunks), hint))
    _check(got == expected.astype(">u2").tobytes(), "sharded basic")
    got = b"".join(bytes(x) for x in engine.passthrough_stream(iter(chunks), hint))
    _check(got == expected.tobytes(), "passthrough")
    print("dryrun mode OK: basic + passthrough via ShardedTorchEngine")


def _dryrun_flat_halo(engine, mesh) -> None:
    """The halo-sharded K2 through the engine, a degenerate batch included."""
    table = MergeTable.build({(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259})
    enc = CudaShardedFlatEncoder(table, mesh, capacity_bytes=2048)
    rng = np.random.default_rng(21)
    hint = enc.payload * enc.n_rows
    corpus = np.concatenate([
        rng.choice(np.frombuffer(b"abcabcaabbcc zq", np.uint8), size=hint + 333).astype(np.uint8),
        np.frombuffer(b"aa" * (enc.HALO + 512), np.uint8),
        rng.choice(np.frombuffer(b"cabcab xy", np.uint8), size=hint // 2).astype(np.uint8),
    ])
    chunks = [corpus[i : i + hint] for i in range(0, corpus.shape[0], hint)]
    before = engine.counts["carry_batches"]
    wire = b"".join(bytes(x) for x in engine._bpe_flat_halo_stream(iter(chunks), table, enc, hint))
    _check(wire == _wire(bpe_numpy.bpe_encode_flat(corpus, table)), "flat halo-sharded")
    _check(engine.counts["carry_batches"] > before, "degenerate batch routing")
    print("dryrun mode OK: flat-halo (incl. the degenerate-run carry composition)")


def _dryrun_sharded_multipass(engine, mesh) -> None:
    """A hierarchical table: the engine's route, and both encoder loops."""
    rng = np.random.default_rng(11)
    merges = {(97, 98): 256, (256, 99): 257, (257, 257): 258, (100, 101): 259}
    table = MergeTable.build(merges)
    chunks = [rng.choice(np.frombuffer(b"abcabcdeabc", np.uint8), size=s).astype(np.uint8)
              for s in (1200, 1, 2048, 33, 999, 2, 640)]
    expected = b"".join(_wire(bpe_numpy.bpe_encode_multipass(c, table)) for c in chunks)
    got = b"".join(bytes(x) for x in engine.bpe_stream(iter(chunks), table, 2048))
    _check(got == expected, "sharded multipass (engine)")
    enc = CudaShardedTokenEncoder(table, mesh, capacity_tokens=2048)
    for lo in range(0, len(chunks), enc.n_rows):
        group = chunks[lo : lo + enc.n_rows]
        want = [bpe_numpy.bpe_encode_multipass(c, table).tolist() for c in group]
        _check([t.tolist() for t in enc.encode_batch(group)] == want, "sharded multipass (host)")
        _check([t.tolist() for t in enc.encode_batch_resident(group)] == want,
               "sharded multipass (resident)")
    print("dryrun mode OK: multipass via the engine, host and resident loops")


def _dryrun_distributed_decode(n_devices: int) -> None:
    """Decode assembly: token-aligned even split, rank order round-trips."""
    rng = np.random.default_rng(17)
    merges = {(97, 98): 256, (98, 99): 257, (99, 97): 258}
    table = MergeTable.build(merges)
    corpus = rng.choice(np.frombuffer(b"abcabcaabbcc", np.uint8), size=4096 + 13).astype(np.uint8)
    tokens = bpe_numpy.bpe_encode_flat(corpus, table)
    wire = np.frombuffer(_wire(tokens), np.uint8)
    exp = build_expansion_table(merges)
    tok_bounds = multihost.even_bounds(tokens.shape[0], n_devices)
    parts = [decode_wire(wire[2 * tok_bounds[i] : 2 * tok_bounds[i + 1]], exp)
             for i in range(n_devices) if tok_bounds[i + 1] > tok_bounds[i]]
    _check(np.concatenate(parts).tobytes() == corpus.tobytes(), "distributed decode")
    print(f"dryrun mode OK: decode-assembly (token-aligned x{n_devices})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-device dry run of the sharded paths")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None, help="run every row on this device (e.g. cpu)")
    args = ap.parse_args(argv)
    devices = None if args.device is None else [torch.device(args.device)] * args.n_devices
    dryrun_multichip(args.n_devices, devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
