"""The six 16-bit probes of ``tools/exp_16bit.py`` on the card.

    python -m blt_tpu_torch.tools.exp_16bit [--size-mib 64] [--k 16]
        [--device cuda|cpu]

Port of ``tools/exp_16bit.py`` (T3). The original runs six single-block
probes on i32[512, 128] ``x = arange % 97``, each asking whether Mosaic
compiles one 16-bit op: a bf16 lane roll, bf16 ``max(b, b * 0.5)``, a bf16
select (lane >= 5, else -1), a bf16 row roll, an i16 lane roll and a bf16
7-step lane max-scan, each back to int32. On the card each is a hand-written
CUDA kernel that computes in ``__nv_bfloat16`` or ``short``
(``csrc/probe16.cu``, ``tools_cuda.probe16``): a warp a row, each lane 4
int32 as one 16-byte vector, 4 rows a warp with their loads issued first,
rolls and the scan by warp shuffles, no shared memory and no barrier. So
there is no compile question; each probe's verdict is ``exact``: the
kernel equals its plain version (``tools_cuda.probe16_plain``, in
``torch.bfloat16`` / ``torch.int16``).

The probes run on the original's x at its 512 rows and at ``size_bytes //
512`` rows (64 MiB of i32 by default), so that one row reports a rate and
not launch cost alone. Each is timed as k launches on the same x, as
launched and as a CUDA-graph replay, beside its plain version and its byte
bound (x read and the result written once); no single PyTorch call computes
any of the six (``library_ms`` null). One JSON line, with ``results`` the
verdict per probe; exits 1 when a result differs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import _common as C

ROWS = 512  # the original's R
K = 16
PROBES = tuple(p for p in tools_cuda.PROBES16 if p.startswith("probe16_"))


def original_x(rows: int) -> torch.Tensor:
    """The originals' input: int32 (rows, 128), ``arange % 97``."""
    return torch.from_numpy(np.arange(rows * C.LANES, dtype=np.int32).reshape(rows, C.LANES) % 97)


def probe_row(probe: str, x: torch.Tensor, k: int, device: torch.device, kernel: str,
              bound_bytes: int, library=None) -> dict:
    """One probe on x: its single launch checked, then k launches timed
    beside the plain version, the bound and ``library``, one PyTorch call of
    the same function (or None)."""
    expect = tools_cuda.probe16_plain(probe, x)
    once = torch.equal(tools_cuda.probe16(probe, x), expect)
    row = {"name": probe.split("_", 1)[1], "kernel": kernel, "x_rows": x.shape[0],
           **C.time_chain(lambda: (C.repeat(lambda: tools_cuda.probe16(probe, x), k),), k,
                          4 * x.numel(), device, (expect,)),
           "bound_ms": C.bound_ms(bound_bytes), "bound_by": "bytes",
           "plain_ms": C.median_ms(lambda: tools_cuda.probe16_plain(probe, x), device),
           "library_ms": (C.chained_ms(lambda: (library(),), k, 4 * x.numel(), device, (expect,))
                          if library else None)}
    row["once_exact"] = once
    row["exact"] = row["exact"] and once
    return row


def measure(device: torch.device, size_bytes: int = 64 * C.MIB, k: int = K) -> dict:
    """The six probes on ``device`` at the original's 512 rows and at
    ``size_bytes // 512`` rows; see the module docstring."""
    sizes = sorted({ROWS, size_bytes // (4 * C.LANES)})
    out = []
    for rows in sizes:
        x = original_x(rows).to(device)
        for probe in PROBES:
            out.append(probe_row(probe, x, k, device, "T3", 8 * x.numel()))
    results = {r["name"]: all(s["exact"] for s in out if s["name"] == r["name"]) for r in out}
    return {"tool": "exp_16bit", "device": C.describe(device), "x_rows": sizes, "k": k,
            "exact": all(results.values()), "rows": out, "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    ap.add_argument("--size-mib", type=int, default=64,
                    help="the second run's x in MiB of int32 (default 64); the original's "
                         f"{ROWS} rows always run")
    ap.add_argument("--k", type=int, default=K, help=f"launches per chain (default {K})")
    args = ap.parse_args(argv)
    result = measure(C.device_of(args.device), args.size_mib * C.MIB, args.k)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
