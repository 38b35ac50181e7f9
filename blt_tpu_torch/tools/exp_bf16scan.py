"""The block-local parity scan of a match mask at 64 MiB, in int32 and in bf16
pairs.

    python -m blt_tpu_torch.tools.exp_bf16scan [--size-mib 64] [--k 64]
        [--density 0.3] [--seed 7] [--device cuda|cpu]

Port of ``tools/exp_bf16scan.py`` (T12). The flat pass's parity scan needs
only each position's last non-match lane (-1..127, exact in bf16), so the
original asks whether a scan on 16-bit values packed two to a lane beats the
int32 one. Both of its kernels compute one function, per block of 1024 rows
x 128: ``start = m & ((i - lz) & 1)``, lz the last zero of the mask at or
before i within the block, -1 if none (``tools_cuda.mask_scan_plain``). The
port's two kernels (``csrc/scan_parts.cu``, ``tools_cuda.mask_scan``) share
one launch design: tiles of 16384 positions, one CTA each, taken from a
ticket, each carrying the parity of its last zero to the next by a
decoupled look-back, a block's start acting as a zero just before it; they
differ in the lane scan inside a thread, in int32 (``i32``) or as
``__nv_bfloat162`` with ``__hmax2`` (``bf16``).

The mask: u8 (rows, 128), each byte 1 with probability ``--density`` (0.3,
the original's; 1.0 is the look-back's worst case: every tile of a block
but its first waits on the one before). Each kernel is chained k times,
each result fed back as the next mask (the original's ``chain``; the chain
reaches a fixed point after its first link, since a start mask fed back
reproduces itself), timed as launched and as a CUDA-graph replay beside the
plain chain and the byte bound; ``k1_equal``: the two kernels' single links
agree. One JSON line, as ``exp_chain``; exits 1 when a timed result differs
from the plain chain's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import _common as C

K = 64
RPB = 1024
DENSITY = 0.3  # share of nonzero mask bytes (the original's)
VARIANTS = tools_cuda.MASK_SCANS


def chain(variant: str, mask: torch.Tensor, k: int = K, rpb: int = RPB) -> torch.Tensor:
    """k scans, each of the result before (the original's ``chain``): kernel
    on CUDA tensors, plain on CPU tensors."""
    for _ in range(k):
        mask = tools_cuda.mask_scan(variant, mask, rpb)
    return mask


def chain_plain(mask: torch.Tensor, k: int = K, rpb: int = RPB) -> torch.Tensor:
    """``chain`` through the plain version."""
    for _ in range(k):
        mask = tools_cuda.mask_scan_plain(mask, rpb)
    return mask


def random_mask(rng: np.random.Generator, rows: int, density: float = DENSITY) -> np.ndarray:
    return (rng.random((rows, C.LANES)) < density).astype(np.uint8)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 7,
            density: float = DENSITY) -> dict:
    """Both kernels on ``device``; see the module docstring."""
    rows = size_bytes // C.LANES
    mask = torch.from_numpy(random_mask(np.random.default_rng(seed), rows, density)).to(device)
    expect = chain_plain(mask, k)
    out = []
    for variant in VARIANTS:
        out.append({
            "name": variant, "kernel": "T12", "rpb": RPB,
            **C.time_chain(lambda variant=variant: (chain(variant, mask, k),), k, size_bytes,
                           device, (expect,)),
            # the mask read and the starts written, once each
            "bound_ms": C.bound_ms(2 * size_bytes), "bound_by": "bytes",
            "plain_ms": C.median_ms(lambda: tools_cuda.mask_scan_plain(mask, RPB), device),
            "library_ms": None,
        })
    k1_equal = torch.equal(*(tools_cuda.mask_scan(v, mask, RPB) for v in VARIANTS))
    ms = {r["name"]: (r["graph"] or r["eager"])["ms_per_launch"]["median"] for r in out}
    return {"tool": "exp_bf16scan", "device": C.describe(device), "size_bytes": size_bytes,
            "density": density, "seed": seed, "k1_equal": k1_equal,
            "exact": k1_equal and all(r["exact"] for r in out), "rows": out,
            "split": {"i32_ms": ms["i32"], "bf16_saves_ms": ms["i32"] - ms["bf16"]}}


def main(argv=None) -> int:
    ap = C.parser(__doc__.splitlines()[0], K)
    ap.set_defaults(seed=7)
    ap.add_argument("--density", type=float, default=DENSITY,
                    help=f"share of nonzero mask bytes (default {DENSITY}, the original's)")
    args = ap.parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed,
                     args.density)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
