"""Generate a conformance corpus with golden outputs from the oracle (port of
``tools/make_conformance.py``: the same files, byte for byte, from the same
seed and merges text).

SURVEY.md 4 calls for emulating the reference's exact-byte tests as a
corpus: inputs + golden outputs derived from the documented semantics
(basic/passthrough analytically, BPE via the trusted pure-Python oracle
transcribed from blt_core/src/tokenizer.rs:61-86). Any engine or the
reference `blt` binary itself can then be diffed against the goldens.

Usage: python -m blt_tpu_torch.tools.make_conformance OUTDIR [--size 1048576]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from blt_tpu_torch.merges import parse_merges_text
from blt_tpu_torch.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes

MERGES_TEXT = "101 32\n116 104\n104 101\n32 116\n97 110\n110 100\n115 32\n\
100 32\n116 32\n111 32\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--size", type=int, default=1024 * 1024)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    rng = np.random.default_rng(0x1234)
    alphabet = np.frombuffer(b"the and of to in east sand ", np.uint8)
    data = rng.choice(alphabet, size=args.size).astype(np.uint8).tobytes()

    def put(name, blob):
        with open(os.path.join(args.outdir, name), "wb") as f:
            f.write(blob)
        print(f"{name}: {len(blob)} bytes")

    put("input.bin", data)
    with open(os.path.join(args.outdir, "merges.txt"), "w") as f:
        f.write(MERGES_TEXT)

    # basic: analytic byte->u16-BE widen
    put("golden_basic.bin", np.frombuffer(data, np.uint8).astype(">u2").tobytes())
    # passthrough: identity
    put("golden_passthrough.bin", data)
    # BPE single-chunk semantics via the oracle
    merges = parse_merges_text(MERGES_TEXT)
    put("golden_bpe.bin", tokens_to_be_bytes(bpe_encode_oracle(data, merges)))
    # content-type headers
    put(
        "golden_basic_type_text.bin",
        b"\xff\x01" + np.frombuffer(data, np.uint8).astype(">u2").tobytes(),
    )
    print("verify with e.g.:")
    print(f"  blt -i {args.outdir}/input.bin -o /tmp/o.bin "
          f"--merges {args.outdir}/merges.txt --chunksize 128MB")
    print(f"  cmp /tmp/o.bin {args.outdir}/golden_bpe.bin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
