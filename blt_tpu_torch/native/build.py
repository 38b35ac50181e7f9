"""Build the port's native host library with g++ (copy of
``blt_tpu/native/build.py``).

Usage: python -m blt_tpu_torch.native.build
The library is built from ``blt_tpu_torch/native/feeder.cpp`` into the
git-ignored ``build/blt_tpu_torch/`` at the repository root, under a name
that carries a hash of the source (``libblt_torch_host_<hash>.so``): a
source change builds a new library and an unchanged tree reuses it. It
never writes into the JAX package. The library is optional: every
consumer falls back to NumPy when it is absent. No pybind11 — the ABI is
plain C via ctypes.
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import sys
import threading
import uuid
from pathlib import Path

SRC = Path(__file__).resolve().parent / "feeder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "blt_tpu_torch"

_build_lock = threading.Lock()


def library_path() -> Path:
    """Path of the library for the current source."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libblt_torch_host_{digest}.so"


def build(verbose: bool = True) -> str:
    # Compile to a private temp name, then atomically rename: concurrent
    # builds (parallel pytest workers, racing threads in one process) never
    # see a half-written .so.
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
            str(SRC), "-o", tmp]
    stderr_tail = ""
    try:
        for cmd in (base[:2] + ["-march=native"] + base[2:], base):
            if verbose:
                print(" ".join(cmd))
            proc = subprocess.run(cmd, capture_output=not verbose)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return str(out)
            if proc.stderr:
                stderr_tail = proc.stderr.decode("utf-8", "replace")[-2000:]
        raise RuntimeError(
            f"g++ failed to build {SRC}"
            + (f":\n{stderr_tail}" if stderr_tail else "")
        )
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def ensure_built() -> str | None:
    """Build the library if the one for this source is missing.

    Returns the .so path, or None when building is impossible/disabled
    (BLT_NATIVE_BUILD=0, no g++, compile error) — callers fall back to
    NumPy. Build failures are logged, not swallowed.
    """
    out = library_path()
    if os.environ.get("BLT_NATIVE_BUILD", "1") == "0":
        return str(out) if out.exists() else None
    with _build_lock:
        if out.exists():
            return str(out)
        try:
            return build(verbose=False)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logging.getLogger("blt_tpu_torch.native").warning(
                "native build failed; falling back to NumPy: %s", e
            )
            return None


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
