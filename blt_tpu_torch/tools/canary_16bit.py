"""The 16-bit toolchain canary of ``tools/canary_16bit.py`` on the card.

    python -m blt_tpu_torch.tools.canary_16bit [--rows 8] [--k 16]
        [--device cuda|cpu]

Port of ``tools/canary_16bit.py`` (T11). The original runs two minimal
kernels on i32[8, 128] ``x = arange % 97``, an i16 lane roll and the strided
sublane read ``x[0::2]`` (-> i32[4, 128]), and reports whether Mosaic
compiles them. On the card both are hand-written CUDA kernels
(``csrc/probe16.cu``; the roll is T3's i16 body, counted as
``canary_i16_roll``), and the verdict is whether each equals its plain
version (``tools_cuda.probe16_plain``).

It prints one JSON line with the original's keys: ``backend`` (the device
type), ``i16_roll_ok`` / ``strided_sublane_ok`` (the kernel equals its plain
version), ``i16_roll_err`` / ``strided_sublane_err`` ("" or what differs)
and ``headroom_unblocked`` (both ok); and with the other tools' timing
fields: each kernel k times, as launched and as a CUDA-graph replay, beside
its plain version, its byte bound and, for the strided read, the single
call ``x[0::2].contiguous()``.

Unlike the original, which always exits 0, it exits 1 when a kernel differs
from its plain version: a verdict that is caught and still exits 0 would
be a hidden failure. A kernel that fails to build or launch raises.
"""

from __future__ import annotations

import argparse
import sys

import torch

from blt_tpu_torch.tools import _common as C
from blt_tpu_torch.tools.exp_16bit import original_x, probe_row

ROWS = 8  # the original's R
K = 16


def measure(device: torch.device, size_bytes: int = ROWS * 4 * C.LANES, k: int = K) -> dict:
    """Both canaries on ``device`` over x of ``size_bytes // 512`` rows (the
    original's 8 by default); see the module docstring."""
    x = original_x(size_bytes // (4 * C.LANES)).to(device)
    half = (x.shape[0] + 1) // 2 * C.LANES
    rows = [probe_row("canary_i16_roll", x, k, device, "T11", 8 * x.numel()),
            # the even rows read and written once
            probe_row("canary_strided_sublane", x, k, device, "T11", 8 * half,
                      lambda: x[0::2].contiguous())]
    out = {"tool": "canary_16bit", "device": C.describe(device), "backend": device.type,
           "x_rows": x.shape[0], "k": k}
    for row in rows:
        body = row["name"]
        out[f"{body}_ok"] = row["exact"]
        out[f"{body}_err"] = "" if row["exact"] else "differs from its plain version"
    out["headroom_unblocked"] = out["i16_roll_ok"] and out["strided_sublane_ok"]
    out["exact"] = out["headroom_unblocked"]
    out["rows"] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    ap.add_argument("--rows", type=int, default=ROWS,
                    help=f"rows of x (default {ROWS}, the original's)")
    ap.add_argument("--k", type=int, default=K, help=f"launches per chain (default {K})")
    args = ap.parse_args(argv)
    result = measure(C.device_of(args.device), args.rows * 4 * C.LANES, args.k)
    C.emit(result)
    return 0 if result["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
