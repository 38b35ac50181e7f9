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
elements per second, the operations bound (64 operations per element, one
per lane each SM issues per clock, 132 x 128, at the card's maximum SM
clock) beside the byte bound, the larger of the two as the bound, and the
plain version's ms. One JSON line; exits 1 when a timed result differs
from the plain chain's.
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


def measure(device: torch.device, size_bytes: int, k: int = K, seed: int = 0) -> dict:
    """The op mix in each type on ``device``; see the module docstring."""
    rng = np.random.default_rng(seed)
    rows = size_bytes // (4 * C.LANES)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=device)
    ops = rows * C.LANES * OPS_PER_REP * tools_cuda.MIX_REPS
    mhz = C.sm_clock_mhz(device)
    out = []
    for name, dtype in tools_cuda.MIX_DTYPES.items():
        # the original's inputs: integers in [0, 100)
        x = torch.from_numpy(rng.integers(0, 100, (rows, C.LANES)).astype(name)).to(device)
        nbytes = x.numel() * x.element_size()
        timing = C.time_chain(lambda x=x: tools_cuda.op_mix(x, tok, k, RPB), k, nbytes,
                              device, tools_cuda.op_mix_plain(x, tok, k, RPB))
        bounds = {"bytes": C.bound_ms(2 * nbytes + 8), "operations": C.ops_bound_ms(ops, mhz)}
        bound_by = max(bounds, key=bounds.get)
        graph_or_eager = timing["graph"] or timing["eager"]
        out.append({
            "name": "op_mix", "kernel": "T5", "dtype": name, "rpb": RPB, **timing,
            "Gelem_per_s": rows * C.LANES / graph_or_eager["ms_per_launch"]["median"] / 1e6,
            "ops": ops, "sm_mhz": mhz, "bytes_bound_ms": bounds["bytes"],
            "ops_bound_ms": bounds["operations"], "bound_ms": bounds[bound_by],
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
