"""End-to-end differential fuzzer: pipeline output vs the semantics oracle
(port of ``tools/fuzz_e2e.py``).

Random corpora x random merge tables (flat and hierarchical) x random
chunk sizes x engines (numpy / torch / shard) x optional content-type
headers, all through the real ``run_tokenizer`` file path. Ground truth
is the pure-Python oracle (``ops/bpe_oracle.py``, a literal transcription
of reference tokenizer.rs semantics); flat tables must be
chunk-size-invariant, general tables are compared per-chunk (the
reference's own chunked behavior, SURVEY.md 2.1.6).

Beside the engines, each trial drives the encoders directly and holds them
against the oracle: ``CudaFlatEncoder`` (K2), the sharded engine's halo
stream over ``CudaShardedFlatEncoder`` (K2 fused with its pack, a slab a
row) and ``CudaTokenEncoder.encode_resident`` (the K3 loop). On the card
they run at the trial's full size; on the CPU they run the kernels' plain
versions under the original's bounds (8192, 16384 and 4096 bytes). Then the
decode round trip, the safe-split plan of the multi-process runner, and
optionally real multi-process runs over gloo.

Usage: python -m blt_tpu_torch.tools.fuzz_e2e [--trials 50] [--seed 0]
    [--max-bytes 200000] [--multiproc-trials 0] [--device {cuda,cpu}]
A bounded version runs in the CPU tests (tests/test_torch_fuzz.py).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from blt_tpu_torch.config import ContentType, CoreConfig
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops.bpe_cuda import CudaFlatEncoder, filter_slots
from blt_tpu_torch.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
from blt_tpu_torch.ops.multipass_cuda import CudaTokenEncoder
from blt_tpu_torch.ops.sharded_cuda import CudaShardedFlatEncoder
from blt_tpu_torch.parallel import multihost
from blt_tpu_torch.pipeline.engines import ShardedTorchEngine, TorchEngine
from blt_tpu_torch.pipeline.runner import run_tokenizer
from blt_tpu_torch.utils.chunking import get_effective_chunk_size
from blt_tpu_torch.utils.device import require_cuda
from blt_tpu_torch.utils.parsing import parse_chunk_size_str

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHARD_ROWS = 4
# input bounds of the encoder legs on the CPU, where they run the kernels'
# plain versions: the original's, set because its interpret mode is slow
CPU_BOUNDS = {"flat": 8192, "halo": 16384, "resident": 4096}


def make_table(rng: np.random.Generator, hierarchical: bool):
    n_rules = int(rng.integers(0, 40))
    merges = {}
    vocab = 256
    for _ in range(n_rules):
        a = int(rng.integers(0, 256))
        b = int(rng.integers(0, 256))
        merges[(a, b)] = vocab
        vocab += 1
    if hierarchical and merges:
        # add rules whose keys reference merged values (multi-pass only)
        for _ in range(int(rng.integers(1, 6))):
            existing = list(merges.values())
            a = int(rng.choice(existing))
            b = int(rng.integers(0, 256))
            merges[(a, b)] = vocab
            vocab += 1
    return merges


def make_corpus(rng: np.random.Generator, merges, max_bytes: int) -> bytes:
    n = int(rng.integers(0, max_bytes))
    if not merges or rng.random() < 0.2:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    # bias towards rule bytes so merges actually fire, with long runs
    # (hierarchical keys contain merged ids >= 256 — not corpus bytes)
    pool = [m for (a, b) in merges for m in (a, b) if m < 256]
    alphabet = np.array(sorted(set(pool))[:16] or [97], dtype=np.uint8)
    out = rng.choice(alphabet, size=n).astype(np.uint8)
    if n > 10 and rng.random() < 0.5:  # adversarial run of one byte
        k = int(rng.integers(2, n // 2))
        out[:k] = alphabet[0]
    return out.tobytes()


def _device(device) -> torch.device:
    return require_cuda() if device is None else torch.device(device)


def _fits(device: torch.device, leg: str, n: int) -> bool:
    """Whether an encoder leg runs on ``n`` bytes: always on the card."""
    return 0 < n and (device.type == "cuda" or n <= CPU_BOUNDS[leg])


def _join(results) -> bytes:
    return b"".join(bytes(memoryview(r).cast("B")) for r in results)


def one_trial(rng: np.random.Generator, trial: int, max_bytes: int, device=None) -> None:
    """One random table, corpus, chunk size and header through every engine
    and encoder leg, each against the oracle. ``device``: where the torch
    and shard engines and the encoders run (None: the first CUDA device)."""
    dev = _device(device)
    hierarchical = rng.random() < 0.3
    merges = make_table(rng, hierarchical)
    table = MergeTable.build(merges) if merges else None
    flat = table.flat if table else True
    data = make_corpus(rng, merges, max_bytes)
    ct = [ContentType.TEXT, ContentType.BIN, None][int(rng.integers(0, 3))]
    chunksize = f"{int(rng.choice([256, 300, 512, 1024]))}KB"

    header = ct.token_value.to_bytes(2, "big") if ct else b""
    # the oracle over the whole input, computed once: the flat expectation
    # and the encoder legs' (a general table's one chunk)
    whole_tokens = bpe_encode_oracle(data, merges)
    whole = tokens_to_be_bytes(whole_tokens)
    if flat:
        expected = header + whole
    else:
        # general tables: per-chunk reference semantics at the effective
        # chunk size (pipeline feeds exactly effective-chunk batches)
        eff = get_effective_chunk_size(parse_chunk_size_str(chunksize), 1, None)
        parts = [whole] if len(data) <= eff else [
            tokens_to_be_bytes(bpe_encode_oracle(data[i : i + eff], merges))
            for i in range(0, len(data), eff)
        ]
        expected = header + b"".join(parts)

    engines = {
        "numpy": "numpy",
        "torch": TorchEngine(dev),
        "shard": ShardedTorchEngine(devices=[dev] * SHARD_ROWS),
    }
    with tempfile.TemporaryDirectory() as td:
        ip = os.path.join(td, "in.bin")
        with open(ip, "wb") as f:
            f.write(data)
        for name, engine in engines.items():
            op = os.path.join(td, f"out.{name}")
            config = CoreConfig.new_from_cli(
                input=ip,
                output=op,
                content_type=ct,
                chunksize=chunksize,
            )
            if merges:
                config.with_merges(merges)
            run_tokenizer(config, engine=engine)
            with open(op, "rb") as f:
                got = f.read()
            assert got == expected, (
                f"trial {trial} engine={name} flat={flat} "
                f"n={len(data)} rules={len(merges)} ct={ct} "
                f"chunk={chunksize}: {len(got)} vs {len(expected)} bytes"
            )

    arr = np.frombuffer(bytearray(data), np.uint8)  # writable: tensors wrap it
    # K2's slots, drained on the host (the engines run K2 fused with its
    # pack; this leg reaches the slot wire and its drop-after-merge rule)
    if flat and merges and _fits(dev, "flat", len(data)) and CudaFlatEncoder.supports(table):
        enc = CudaFlatEncoder(table, dev)
        slots, n, _ = enc.encode(arr, False, -1)
        toks_be, _ = filter_slots(slots.reshape(-1)[:n].cpu().numpy(), 0)
        got = bytes(memoryview(toks_be).cast("B"))
        assert got == whole, (
            f"trial {trial}: flat encoder mismatch ({len(got)} vs {len(whole)} bytes)"
        )

    # the halo-convergence sharded flat stream over SHARD_ROWS rows of the
    # device: slab packing, convergence detection, the degenerate-run
    # carry composition and the stateless per-slab drain across random
    # chunkings. Bounded: every 4th eligible trial.
    if (flat and merges and _fits(dev, "halo", len(data)) and trial % 4 == 0
            and CudaShardedFlatEncoder.supports(table)):
        mesh = [dev] * SHARD_ROWS
        enc = CudaShardedFlatEncoder(table, mesh, capacity_bytes=2048)
        eng = ShardedTorchEngine(devices=mesh)
        hint = enc.payload * enc.n_rows
        step = int(rng.integers(1, hint + 1))
        chunks = [arr[i : i + step] for i in range(0, arr.shape[0], step)]
        wire = _join(eng._bpe_flat_halo_stream(iter(chunks), table, enc, hint))
        assert wire == whole, (
            f"trial {trial}: halo-sharded flat stream mismatch "
            f"({len(wire)} vs {len(whole)} bytes, step={step})"
        )

    # the device-resident multipass loop (K3 rounds on the card): the
    # engines route a general table through it, a flat one never
    if merges and _fits(dev, "resident", len(data)) and CudaTokenEncoder.supports(table):
        enc = CudaTokenEncoder(table, dev)
        got_t = enc.encode_resident(arr).tolist()
        assert got_t == whole_tokens, (
            f"trial {trial}: resident multipass mismatch "
            f"({len(got_t)} vs {len(whole_tokens)} tokens, "
            f"rules={len(merges)} flat={flat})"
        )

    # decode roundtrip: every invertible fuzzed table must satisfy
    # decode(encode(x)) == x through the real pipeline (ops/decode.py).
    # Fuzzed values are unique and >= 256, so invertibility only depends
    # on the expansion build succeeding (hierarchical chains stay acyclic
    # by construction: new rules only reference earlier values).
    with tempfile.TemporaryDirectory() as td:
        enc_path = os.path.join(td, "enc.bin")
        dec = os.path.join(td, "dec.bin")
        with open(enc_path, "wb") as f:
            f.write(expected)
        dconfig = CoreConfig.new_from_cli(
            input=enc_path, output=dec, content_type=ct, chunksize=chunksize,
            decode=True,
        )
        if merges:
            dconfig.with_merges(merges)
        run_tokenizer(dconfig)
        with open(dec, "rb") as f:
            back = f.read()
        # per-chunk encode of general tables still decodes to the
        # original bytes (expansion is position-independent)
        assert back == data, (
            f"trial {trial}: decode roundtrip mismatch "
            f"({len(back)} vs {len(data)} bytes, flat={flat})"
        )

    # multi-process split planning: safe splits must be merge-transparent
    # for every fuzzed flat table/corpus (parallel/multihost.py)
    if flat and merges and len(data):
        nproc = int(rng.integers(2, 6))
        bounds = multihost.safe_split_bounds(arr, table.dense, nproc)
        parts = [
            tokens_to_be_bytes(bpe_encode_oracle(data[bounds[i] : bounds[i + 1]], merges))
            for i in range(nproc)
        ]
        assert header + b"".join(parts) == expected, (
            f"trial {trial}: host-split assembly mismatch "
            f"(nproc={nproc}, bounds={bounds})"
        )


# a rank of a multi-process run: the runner's multi-process branch joins the
# gloo group from BLT_COORDINATOR_ADDRESS / BLT_NUM_PROCESSES /
# BLT_PROCESS_ID; the rank loads nothing of the JAX package
_MP_WORKER = """
import json, sys
spec = json.loads(sys.argv[1])
from blt_tpu_torch.config import ContentType, CoreConfig, Engine
from blt_tpu_torch.parallel import distributed as dist
from blt_tpu_torch.pipeline.runner import run_tokenizer
cfg = CoreConfig.new_from_cli(
    input=spec["input"], output=spec["output"],
    content_type=ContentType.from_cli(spec["ct"]) if spec["ct"] else None,
    chunksize=spec["chunksize"], passthrough=spec["passthrough"],
    decode=spec["decode"], engine=Engine(spec["engine"]),
)
if spec["merges"]:
    cfg.with_merges({(a, b): v for a, b, v in spec["merges"]})
run_tokenizer(cfg)
assert dist.process_count() == spec["nproc"], dist.process_count()
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("blt_tpu", "tools", "jax"))
assert not bad, bad
"""


def one_multiproc_trial(
    rng: np.random.Generator, trial: int, max_bytes: int = 100_000, device=None
) -> None:
    """A real multi-process execution leg.

    Launches nproc processes of the public runner over gloo (random corpus
    / table incl. hierarchical / mode incl. decode / explicit chunk size,
    exercising safe-split for flat tables and chunk-grid alignment for
    non-flat) writing ONE shared output file, and byte-compares against
    the single-process run. This fuzzes the multi-process *execution*
    path (spool, all-gather, pwrite assembly), not just its planning math.
    The ranks run the torch engine when ``device`` is a CUDA device (they
    share it), else the NumPy engine.
    """
    dev = _device(device)
    engine = "torch" if dev.type == "cuda" else "numpy"
    hierarchical = rng.random() < 0.4
    merges = make_table(rng, hierarchical)
    passthrough = not merges and rng.random() < 0.3
    data = make_corpus(rng, merges, max_bytes)
    ct = [None, "text", "bin"][int(rng.integers(0, 3))]
    chunksize = f"{int(rng.choice([256, 300, 512]))}KB"
    nproc = int(rng.integers(2, 4))
    run_decode = bool(merges) and rng.random() < 0.4

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def launch(spec):
        def env_for(pid):
            env = dict(os.environ)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            env["BLT_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
            env["BLT_NUM_PROCESSES"] = str(nproc)
            env["BLT_PROCESS_ID"] = str(pid)
            return env

        # stderr to temp files (not pipes): a chatty worker blocking on a
        # full pipe before the group's barrier would deadlock the
        # sequential reaping below
        errs = [
            tempfile.NamedTemporaryFile(prefix=f"blt_fuzz_err{pid}_")
            for pid in range(nproc)
        ]
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", _MP_WORKER, json.dumps(spec)],
                env=env_for(pid),
                stdout=subprocess.DEVNULL,
                stderr=errs[pid],
            )
            for pid in range(nproc)
        ]
        try:
            for pid, p in enumerate(procs):
                p.wait(timeout=300)
                errs[pid].seek(0)
                assert p.returncode == 0, (
                    f"trial {trial} (mp): worker {pid} failed:\n"
                    f"{errs[pid].read().decode()}"
                )
        finally:
            # a failed/timed-out worker must not leave siblings blocked
            # on the dead coordinator
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for e in errs:
                e.close()

    ct_obj = ContentType.from_cli(ct) if ct else None
    merges_wire = [[a, b, v] for (a, b), v in merges.items()]
    with tempfile.TemporaryDirectory() as td:
        ip = os.path.join(td, "in.bin")
        with open(ip, "wb") as f:
            f.write(data)

        # single-process reference (same explicit chunk grid)
        op_ref = os.path.join(td, "ref.bin")
        cfg = CoreConfig.new_from_cli(
            input=ip, output=op_ref, content_type=ct_obj,
            chunksize=chunksize, passthrough=passthrough,
        )
        if merges:
            cfg.with_merges(merges)
        run_tokenizer(cfg, engine="numpy")
        with open(op_ref, "rb") as f:
            expected = f.read()

        op = os.path.join(td, "mp.bin")
        launch({
            "input": ip, "output": op, "ct": ct, "chunksize": chunksize,
            "passthrough": passthrough, "decode": False,
            "merges": merges_wire, "nproc": nproc, "engine": engine,
        })
        with open(op, "rb") as f:
            got = f.read()
        assert got == expected, (
            f"trial {trial} (mp): {nproc}-process output mismatch "
            f"(n={len(data)} rules={len(merges)} ct={ct} "
            f"chunk={chunksize} passthrough={passthrough}: "
            f"{len(got)} vs {len(expected)} bytes)"
        )

        if run_decode and expected and not passthrough:
            dec = os.path.join(td, "dec.bin")
            launch({
                "input": op, "output": dec, "ct": ct,
                "chunksize": chunksize, "passthrough": False,
                "decode": True, "merges": merges_wire, "nproc": nproc,
                "engine": engine,
            })
            with open(dec, "rb") as f:
                back = f.read()
            assert back == data, (
                f"trial {trial} (mp): {nproc}-process decode mismatch "
                f"({len(back)} vs {len(data)} bytes)"
            )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-bytes", type=int, default=200_000)
    ap.add_argument(
        "--multiproc-trials", type=int, default=0,
        help="additional trials launching REAL 2-3 process gloo runs "
             "(slow: seconds a trial of process startup)",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the torch and shard engines and the encoders "
                         "run (default: the first CUDA device; fails without one)")
    args = ap.parse_args(argv)

    # small device batches, so that a trial spans several
    os.environ.setdefault("BLT_DEVICE_BATCH_BYTES", str(128 * 1024))
    device = require_cuda() if args.device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(args.seed)
    for t in range(args.trials):
        one_trial(rng, t, args.max_bytes, device)
        if (t + 1) % 10 == 0:
            print(f"{t + 1}/{args.trials} trials ok", file=sys.stderr)
    for t in range(args.multiproc_trials):
        one_multiproc_trial(rng, t, args.max_bytes, device)
        print(f"multiproc {t + 1}/{args.multiproc_trials} ok", file=sys.stderr)
    print(
        f"fuzz: {args.trials} trials passed on {device}"
        + (f" + {args.multiproc_trials} multiproc" if args.multiproc_trials else "")
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
