"""File-to-file runs on the card's engine at three device batch sizes, a small run's phases and the bare link.

    python -m blt_tpu_torch.tools.exp_e2e [--size-mib 100] [--batches-mb 64,16,8]
        [--mode basic|bpe|passthrough] [--k 1] [--seed 0] [--device cuda|cpu]

Port of ``tools/exp_e2e.py``. In a temporary directory it writes
``--size-mib`` MiB of the original's file (``make_file``: a 4 MiB base of
its 19-letter alphabet from ``default_rng(--seed)``, tiled) and its
4-pair merges file, then:

- for each of ``--batches-mb``: ``BLT_DEVICE_BATCH_BYTES`` set to that many
  MiB (read by ``pipeline/runner.py``'s ``_device_batch_bytes``), a warm
  run, then ``--k`` timed runs (the original's one) through the port's
  ``run_tokenizer`` with ``TorchEngine(device)``, the engine
  ``--engine torch`` selects; the stage split of the timed runs
  (``feeder.stage_stats(reset=True)``: seconds each stage spent producing,
  handing on and waiting) beside the MB/s (1e6 bytes);
- on a 10 MiB file (at most ``--size-mib``), at 16 MiB batches after a warm
  run: ``CoreConfig.new_from_cli`` seconds and ``run_tokenizer`` seconds;
- the bare copies of the same 10 MiB, made as the pipeline makes them: the
  upload from pinned staging (``feeder.pinned_buffer``, ``feeder.upload``)
  and the download of its 2-byte widening by ``.cpu()`` into pageable
  memory (as the engines' drain does), each synchronized.

Every output file's sha256 is held to the NumPy engine's (``--engine
numpy``) on the same file, and the download to the widened bytes. On
``--device cpu`` the engine object runs the plain versions on the CPU.
The runs are timed by the wall clock; ``bound_ms`` is the bytes the card
must move (the input read, the output written) over its memory rate. One
JSON line; exits 1 when an output differs.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from blt_tpu_torch.config import CoreConfig, Engine
from blt_tpu_torch.ops.bpe_torch import basic_encode
from blt_tpu_torch.pipeline import feeder
from blt_tpu_torch.pipeline.engines import TorchEngine
from blt_tpu_torch.pipeline.runner import run_tokenizer
from blt_tpu_torch.tools import _common as C

K = 1  # timed runs a batch size (the original's one)
SIZE_MIB = 100
BATCHES_MB = (64, 16, 8)
SMALL = 10 * C.MIB  # the original's phase-timed run
SMALL_BATCH = 16 * C.MIB
MODES = ("basic", "bpe", "passthrough")
MERGES = ((101, 116), (116, 97), (97, 111), (32, 101))
ALPHABET = b"etaoinshrdlu cmfwyp"


def make_file(path: str, size: int, seed: int = 0) -> None:
    """``benches/pipeline_benchmark.py``'s recipe: a 4 MiB base of the
    19-letter alphabet, written again and again to ``size`` bytes."""
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(ALPHABET, np.uint8), size=4 * C.MIB).astype(np.uint8)
    with open(path, "wb") as f:
        written = 0
        while written < size:
            n = min(base.shape[0], size - written)
            f.write(base[:n].tobytes())
            written += n


def run_once(input_path, output_path, mode, engine, merges_path=None) -> float:
    """Seconds of one ``run_tokenizer`` (the original's ``run_once``)."""
    config = CoreConfig.new_from_cli(
        input=input_path,
        output=output_path,
        merges=merges_path if mode == "bpe" else None,
        passthrough=(mode == "passthrough"),
        engine=Engine.TORCH,
    )
    t0 = time.perf_counter()
    run_tokenizer(config, engine=engine)
    return time.perf_counter() - t0


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def link_copies(path: str, device: torch.device) -> dict:
    """The upload of the file's bytes from pinned staging and the download
    of their widening into pageable memory, each synchronized, after a
    1 MiB warm-up of both."""
    x = np.fromfile(path, dtype=np.uint8)
    staging = feeder.pinned_buffer(x.shape[0], device)
    staging.numpy()[:] = x

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    basic_encode(feeder.upload(staging[: C.MIB], device)).cpu()
    t0 = time.perf_counter()
    d = feeder.upload(staging, device)
    h2d = time.perf_counter() - t0
    out = basic_encode(d)
    sync()
    t0 = time.perf_counter()
    host = out.cpu()
    d2h = time.perf_counter() - t0
    exact = np.array_equal(host.numpy(), x.astype(np.uint16) << 8)
    return {"bytes": int(x.shape[0]), "h2d_s": h2d, "d2h2x_s": d2h,
            "h2d_MB_per_s": x.shape[0] / h2d / 1e6, "d2h_MB_per_s": 2 * x.shape[0] / d2h / 1e6,
            "exact": bool(exact)}


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0,
            batches_mb=BATCHES_MB, mode: str = "basic") -> dict:
    """Every run on ``device``; see the module docstring."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    engine = TorchEngine(device)
    rows = []
    with tempfile.TemporaryDirectory() as td:
        ip, op, mp = (os.path.join(td, name) for name in ("in.bin", "out.bin", "m.txt"))
        make_file(ip, size_bytes, seed)
        with open(mp, "w") as f:
            f.writelines(f"{a} {b}\n" for a, b in MERGES)
        ref = os.path.join(td, "ref.bin")
        run_once(ip, ref, mode, "numpy", mp)
        want, out_bytes = sha256_file(ref), os.path.getsize(ref)
        with C.env("BLT_DEVICE_BATCH_BYTES", str(SMALL_BATCH)):
            for bs_mb in batches_mb:
                os.environ["BLT_DEVICE_BATCH_BYTES"] = str(bs_mb * C.MIB)
                run_once(ip, op, mode, engine, mp)  # warm
                feeder.stage_stats(reset=True)
                timing, _ = C.time_wall(lambda: run_once(ip, op, mode, engine, mp), size_bytes,
                                        device, reps=k, force=None, warm=False)
                stages = feeder.stage_stats(reset=True)
                rows.append(C.wall_row(f"batch_{bs_mb}mb", None, timing,
                                       size_bytes + out_bytes, sha256_file(op) == want,
                                       batch_bytes=bs_mb * C.MIB, runs=k, stage_stats=stages))

            # the small run's phases, and the bare link on the same bytes
            small = min(SMALL, size_bytes)
            ip10 = os.path.join(td, "in10.bin")
            make_file(ip10, small, seed)
            run_once(ip10, ref, mode, "numpy", mp)
            want10 = sha256_file(ref)
            os.environ["BLT_DEVICE_BATCH_BYTES"] = str(SMALL_BATCH)
            run_once(ip10, op, mode, engine, mp)  # warm
            t0 = time.perf_counter()
            config = CoreConfig.new_from_cli(input=ip10, output=op,
                                             merges=mp if mode == "bpe" else None,
                                             passthrough=(mode == "passthrough"),
                                             engine=Engine.TORCH)
            config_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_tokenizer(config, engine=engine)
            run_s = time.perf_counter() - t0
            small_run = {"bytes": small, "config_s": config_s, "run_s": run_s,
                         "MB_per_s": small / run_s / 1e6, "exact": sha256_file(op) == want10}
            link = link_copies(ip10, device)
    exact = all(r["exact"] for r in rows) and small_run["exact"] and link["exact"]
    return {"tool": "exp_e2e", "device": C.describe(device), "size_bytes": size_bytes,
            "mode": mode, "seed": seed, "exact": exact, "rows": rows,
            "small_run": small_run, "small_link": link}


def main(argv=None) -> int:
    ap = C.parser(__doc__.splitlines()[0], K, SIZE_MIB, "timed runs a batch size")
    ap.add_argument("--batches-mb", default=",".join(map(str, BATCHES_MB)),
                    help="device batch sizes in MiB, comma-separated (default 64,16,8)")
    ap.add_argument("--mode", default="basic", choices=MODES)
    args = ap.parse_args(argv)
    batches = [int(x) for x in args.batches_mb.split(",")]
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed,
                     batches, args.mode)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
