"""Integer op rate in int32, int16 and int8: an op mix chained through a token.

    python -m blt_tpu_torch.tools.exp_pack [--size-mib 8] [--k 64] [--seed 0]
        [--device cuda|cpu]

Port of ``tools/exp_pack.py`` (T5). Each element of a (rows, 128) tensor
goes through 8 repetitions of an integer op mix (multiply, shift, and, a
roll by one lane within the row, compare, select, max, add; every op
wrapping in the element type), ``csrc/op_mix.cu``,
``tools_cuda.op_mix``. The chain is k launches that each read the same
input and take the token the launch before wrote, as the original's.
``--size-mib`` is the int32 input's size (8 MiB: the original's 16384 rows
of 128); int16 and int8 keep the row count, so each type computes the same
number of elements in fewer bytes.

Per type: ms per launch as launched and as a CUDA-graph replay, the
elements per second, the operations bound beside the byte bound, the larger
of the two as the bound, and the plain version's ms. The operations are 64
per element counted in 32-bit lane operations, one per lane each SM issues
per clock (132 x 128) at the card's maximum SM clock: int16 and int8 carry
two and four elements a 32-bit lane (``LANE_ELEMENTS``), so their count is
a half and a quarter of int32's; ``ops_bound_32_ms`` is the bound at one
element a lane, as for int32. One JSON line; exits 1 when a timed result
differs from the plain chain's.

``edge_rows`` makes the inputs that hold the kernels' packed arithmetic to
the plain version (``chip_smoke.py`` and the CPU tests).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import _common as C

K = 64
SIZE_MIB = 8
RPB = 1024
# the operations each element needs per repetition: mul, shift, and, and,
# compare, select, max, add. Not counted: the roll, a move of data; the
# lane >= 2 test, the same in every repetition and row; and its select,
# which only lanes 0 and 1 take.
OPS_PER_REP = 8
# elements one 32-bit lane carries through the mix (op_mix.cu)
LANE_ELEMENTS = {"int32": 1, "int16": 2, "int8": 4}


def _mix_y(v: np.ndarray, bits: int) -> np.ndarray:
    """The mix's y = ((v * 31) >> 3) & 0x3F, the product wrapped to ``bits``."""
    half = 1 << (bits - 1)
    p = ((v.astype(np.int64) * 31 + half) & ((1 << bits) - 1)) - half
    return (p >> 3) & 0x3F


def edge_rows(name: str, rows: int, seed: int = 0) -> np.ndarray:
    """``rows`` rows of 128 of type ``name`` (at least 40): the edge rows
    first, then random rows over the type's whole range. Edge rows: on a
    random background, the type's min, max, -1 and 0 at lanes 0, 1, 2 and
    127 together and one at a time, and at both lanes beside every 32-bit
    word's and every 16-byte vector's boundary; rows of one edge value;
    rows of values whose y equals their low 6 bits, so the first
    repetition's select takes the roll, alone and between edge values."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(name)
    bits = info.bits
    lane = np.arange(C.LANES)

    def noise(n):
        return rng.integers(info.min, info.max + 1, (n, C.LANES), dtype=np.int64)

    edges = (info.min, info.max, -1, 0)
    ends = (0, 1, 2, C.LANES - 1)
    out = []
    for e in edges:
        masks = [np.isin(lane, ends)] + [lane == l for l in ends]
        for span in (32 // bits, 128 // bits):  # a word's, a vector's elements
            masks.append((lane % span == 0) | (lane % span == span - 1))
        for m in masks:
            row = noise(1)[0]
            row[m] = e
            out.append(row)
        out.append(np.full(C.LANES, e))
    # y depends on v mod 512 (mod 256 in int8): the residues that fire
    residue = np.arange(1 << min(bits, 9))
    fire = residue[_mix_y(residue, bits) == (residue & 0x3F)]
    for _ in range(4):
        v = rng.choice(fire, C.LANES) + (noise(1)[0] >> 9 << 9 if bits > 9 else 0)
        out.append(v)
        w = v.copy()
        w[::3] = rng.choice(edges, len(w[::3]))
        out.append(w)
    if rows < len(out):
        raise ValueError(f"the {len(out)} edge rows do not fit in {rows} rows")
    return np.concatenate([np.stack(out), noise(rows - len(out))]).astype(name)


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The op mix in each type on ``device``; see the module docstring."""
    rng = np.random.default_rng(seed)
    rows = size_bytes // (4 * C.LANES)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=device)
    ops32 = rows * C.LANES * OPS_PER_REP * tools_cuda.MIX_REPS
    mhz = C.sm_clock_mhz(device)
    out = []
    for name, dtype in tools_cuda.MIX_DTYPES.items():
        # the original's inputs: integers in [0, 100)
        x = torch.from_numpy(rng.integers(0, 100, (rows, C.LANES)).astype(name)).to(device)
        nbytes = x.numel() * x.element_size()
        timing = C.time_chain(lambda x=x: tools_cuda.op_mix(x, tok, k, RPB), k, nbytes,
                              device, tools_cuda.op_mix_plain(x, tok, k, RPB))
        ops = ops32 // LANE_ELEMENTS[name]
        bounds = {"bytes": C.bound_ms(2 * nbytes + 8), "operations": C.ops_bound_ms(ops, mhz)}
        bound_by = max(bounds, key=bounds.get)
        graph_or_eager = timing["graph"] or timing["eager"]
        out.append({
            "name": "op_mix", "kernel": "T5", "dtype": name, "rpb": RPB, **timing,
            "Gelem_per_s": rows * C.LANES / graph_or_eager["ms_per_launch"]["median"] / 1e6,
            "ops": ops, "sm_mhz": mhz, "bytes_bound_ms": bounds["bytes"],
            "ops_bound_ms": bounds["operations"], "ops_bound_32_ms": C.ops_bound_ms(ops32, mhz),
            "bound_ms": bounds[bound_by],
            "bound_by": bound_by,
            "plain_ms": C.median_ms(lambda x=x: tools_cuda.op_mix_plain(x, tok, 1, RPB), device),
            "library_ms": None,
        })
    return {"tool": "exp_pack", "device": C.describe(device), "size_bytes": size_bytes,
            "rows": out, "seed": seed, "exact": all(r["exact"] for r in out)}


def main(argv=None) -> int:
    args = C.parser(__doc__.splitlines()[0], K, SIZE_MIB).parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k, args.seed)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
