"""Training command-line interface (port of ``blt_tpu/train_cli.py``; a
capability extension over the reference, which only consumes pre-built
merges files — blt_core/src/config_loader.rs).

    python -m blt_tpu_torch.train_cli CORPUS -o merges.txt -n 500 \
        [--checkpoint FILE] [--checkpoint-every K] [--resume] \
        [--rows B] [--row-bytes N] [--device {cuda,cpu}]

Learns merge rules from a byte corpus with the greedy max-frequency
procedure (blt_tpu_torch/parallel/train.py) and writes a merges.txt the
reference loader grammar accepts. With --rows > 1 the corpus is split into
rows and trained row-parallel on one device; with --checkpoint the full
training state is persisted crash-safely (the JAX trainer's format, so
either trainer resumes the other's state) and --resume continues an
interrupted run to the identical result. Training runs on the first CUDA
device and exits 1 without one; ``--device cpu`` runs it on the host.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blt-train",
        description="Learn BPE merges from a byte corpus (greedy max-frequency)",
    )
    p.add_argument("corpus", metavar="CORPUS", help="Input corpus file")
    p.add_argument("-o", "--output", metavar="FILE", required=True,
                   help="Output merges.txt path")
    p.add_argument("-n", "--num-merges", metavar="N", type=int, default=256,
                   help="Number of merge rules to learn (default: 256)")
    p.add_argument("--rows", metavar="B", type=int, default=1,
                   help="Data-parallel corpus rows (default: 1 = single sequence)")
    p.add_argument("--row-bytes", metavar="N", type=int, default=0,
                   help="Bytes per row (default: corpus size / rows)")
    p.add_argument("--checkpoint", metavar="FILE", default=None,
                   help="Checkpoint state file (.npz)")
    p.add_argument("--checkpoint-every", metavar="K", type=int, default=25,
                   help="Checkpoint every K learned rules (default: 25)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from --checkpoint when it exists")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where training runs (default: cuda, the first CUDA "
                        "device; fails without one)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from blt_tpu_torch.parallel.train import (
        learn_bpe,
        learn_bpe_sharded,
        save_merges,
    )
    from blt_tpu_torch.utils.device import require_cuda
    from blt_tpu_torch.utils.logging import configure, get_logger

    configure()
    log = get_logger("train-cli")
    args = build_parser().parse_args(argv)

    try:
        data = np.fromfile(args.corpus, dtype=np.uint8)
        if data.shape[0] == 0:
            raise ValueError("corpus is empty")
        device = require_cuda() if args.device == "cuda" else torch.device("cpu")
        if args.rows > 1 or args.checkpoint:
            rows = max(args.rows, 1)
            row_bytes = args.row_bytes or -(-data.shape[0] // rows)
            batch = np.zeros((rows, row_bytes), np.uint8)
            lengths = np.zeros(rows, np.int32)
            for r in range(rows):
                piece = data[r * row_bytes : (r + 1) * row_bytes]
                batch[r, : piece.shape[0]] = piece
                lengths[r] = piece.shape[0]
            merges = learn_bpe_sharded(
                batch,
                lengths,
                args.num_merges,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every if args.checkpoint else 0,
                resume=args.resume,
                device=device,
            )
        else:
            merges = learn_bpe(data, args.num_merges, device=device)
        save_merges(merges, args.output)
        log.info("learned %d rules -> %s", len(merges), args.output)
    except (OSError, ValueError, RuntimeError) as e:
        # RuntimeError: no CUDA device (require_cuda)
        print(f"Error training merges: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
