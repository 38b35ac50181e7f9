"""Command-line interface of the torch port (port of ``blt_tpu/cli.py``).

Same flags as ``blt``; ``--engine`` chooses torch (the default: the CUDA
kernels), shard (the kernels on every CUDA device), numpy (the host engine)
or auto:

    python -m blt_tpu_torch.cli [-i FILE] [-o FILE] [--merges FILE]
        [--passthrough] [--decode] [--type text|audio|bin|video]
        [--threads N] [--memcap PCT] [--chunksize SIZE]
        [--engine torch|numpy|auto|shard]

Errors print ``Error running tokenizer: ...`` on stderr and exit 1; that
includes the default ``--engine torch``, and ``--engine shard``, on a
machine without a CUDA device (decode is host-only by design and needs
none). With ``BLT_COORDINATOR_ADDRESS``, ``BLT_NUM_PROCESSES`` and
``BLT_PROCESS_ID`` set, each process tokenizes its byte range into the
shared output (``blt_tpu_torch/parallel/multihost.py``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from blt_tpu_torch._version import __version__
from blt_tpu_torch.pipeline.engines import ENGINES


def _u8(value: str) -> int:
    """clap-style u8 parse for --memcap (as the JAX package's CLI)."""
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid digit found in string: {value!r}")
    if not 0 <= n <= 255:
        raise argparse.ArgumentTypeError(f"{n} is not in 0..=255")
    return n


def _usize(value: str) -> int:
    """clap-style usize parse for --threads (as the JAX package's CLI)."""
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid digit found in string: {value!r}")
    if n < 0:
        raise argparse.ArgumentTypeError(f"{n} is negative (expected usize)")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blt",
        description="Byte-level tokenizer on PyTorch + CUDA (basic / BPE / passthrough)",
    )
    p.add_argument("-i", "--input", metavar="FILE", default=None,
                   help="Input file path (or - for stdin)")
    p.add_argument("-o", "--output", metavar="FILE", default=None,
                   help="Output file path (or - for stdout)")
    p.add_argument("--merges", metavar="FILE", default=None,
                   help="BPE merges file for advanced tokenization")
    p.add_argument("--passthrough", action="store_true",
                   help="Use passthrough mode (copy file without tokenization)")
    p.add_argument("--decode", action="store_true",
                   help="Invert a token stream produced by this tokenizer "
                        "(use the same --merges/--type the encoding run used)")
    p.add_argument("--type", dest="content_type", default=None,
                   choices=["text", "audio", "bin", "video"],
                   help="Prepend content-type token")
    p.add_argument("--threads", metavar="NUM", type=_usize, default=None,
                   help="Override worker count (default: auto based on cores)")
    p.add_argument("--memcap", metavar="PERCENT", type=_u8, default=None,
                   help="Max RAM usage fraction (e.g., 70 for 70%%)")
    p.add_argument("--chunksize", metavar="SIZE", default=None,
                   help="Min/Max chunk size (e.g. 4MB, 256KB).")
    p.add_argument("--engine", default="torch", choices=list(ENGINES),
                   help="Compute backend (default: torch, the CUDA kernels, "
                        "which need a CUDA device; shard = the kernels on every "
                        "CUDA device; numpy = the host engine)")
    p.add_argument("--version", action="version", version=f"blt {__version__}")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    from blt_tpu_torch.config import ContentType, CoreConfig, Engine
    from blt_tpu_torch.utils.logging import configure, get_logger
    from blt_tpu_torch.utils.profiling import job
    from blt_tpu_torch.pipeline.runner import run_tokenizer

    configure()
    # one job: its set-up holds the argument parse and the merges file's
    with job(get_logger("cli")):
        args = build_parser().parse_args(argv)
        try:
            config = CoreConfig.new_from_cli(
                input=Path(args.input) if args.input else None,
                output=Path(args.output) if args.output else None,
                merges=Path(args.merges) if args.merges else None,
                content_type=(
                    ContentType.from_cli(args.content_type) if args.content_type else None
                ),
                threads=args.threads,
                chunksize=args.chunksize,
                memcap=args.memcap,
                passthrough=args.passthrough,
                decode=args.decode,
                engine=Engine(args.engine),
            )
            run_tokenizer(config)
        except (OSError, ValueError, RuntimeError) as e:
            print(f"Error running tokenizer: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
