"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``blt_tpu_torch/csrc/*.cu`` file is compiled for Hopper (``sm_90a``),
one nvcc process per source, all started together, and the objects are
linked into one shared library with a plain C interface, in
``build/blt_tpu_torch/`` at the repository root. The library's name carries
a hash of the sources and flags, so a source change rebuilds it and an
unchanged tree reuses it. The build runs at first use (the first kernel
launch), never at import.

There is no fallback: a missing ``nvcc`` or a failed compile raises. Run
``python -m blt_tpu_torch.ops._cuda_build`` to build ahead of time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
import uuid
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "blt_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's compile
ptxas_log: dict[str, str] = {}  # source stem -> what ptxas printed (-v) in this process's compile


def _sources() -> list[str]:
    return sorted(glob.glob(str(CSRC / "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        h.update(Path(src).read_bytes())
    for hdr in sorted(glob.glob(str(CSRC / "*.cuh"))):
        h.update(Path(hdr).read_bytes())
    return BUILD_DIR / f"libblt_cuda_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with the first failure's output.
    Returns each command's standard error."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    failed, errs = None, []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err[-4000:]}"
    if failed:
        raise RuntimeError(failed)
    return errs


def build() -> Path:
    """Compile the kernels if the library for these sources is missing."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to private names and rename: a concurrent build never loads
    # a half-written library
    tag = f"tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    tmp = out.with_name(f"{out.name}.{tag}")
    objs = [BUILD_DIR / f"{Path(src).stem}.{tag}.o" for src in _sources()]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        errs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), src]
                     for src, obj in zip(_sources(), objs)])
        ptxas_log.update((Path(src).stem, err) for src, err in zip(_sources(), errs))
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for f in (tmp, *objs):
            if f.exists():
                f.unlink()
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.blt_widen.argtypes = [p, p, i64, p]
        lib.blt_widen.restype = i
        lib.blt_flat_pass.argtypes = [i, p, i, i, i, p, p, p, p, p, p]
        lib.blt_flat_pass.restype = i
        lib.blt_pack_slots.argtypes = [p, i, i, p, p, p, p]
        lib.blt_pack_slots.restype = i
        lib.blt_flat_packed.argtypes = [p, i, i, i, p, p, p, p, p, p, p, p]
        lib.blt_flat_packed.restype = i
        lib.blt_chain.argtypes = [i, p, p, i64, p, p, p, i, i, i, p]
        lib.blt_chain.restype = i
        u = ctypes.c_uint
        lib.blt_token_pass.argtypes = [i, p, i, i, p, p, p, p, i, u, u, i, p, p, p]
        lib.blt_token_pass.restype = i
        lib.blt_token_pass_gap.argtypes = [p, i, p, p, p, p, i, u, u, i, p, p, p]
        lib.blt_token_pass_gap.restype = i
        lib.blt_subgather.argtypes = [p, p, p, i64, i, i, p, p]
        lib.blt_subgather.restype = i
        lib.blt_op_mix.argtypes = [i, p, p, i, p, p, p, i, i, p]
        lib.blt_op_mix.restype = i
        lib.blt_copy_tokens.argtypes = [p, i, p, p]
        lib.blt_copy_tokens.restype = i
        lib.blt_block_scan.argtypes = [i, p, i, i, i, p, p, p, p, p, i, p]
        lib.blt_block_scan.restype = i
        lib.blt_row_scan.argtypes = [p, i, i, i, p, p, p, p, p, i, p]
        lib.blt_row_scan.restype = i
        lib.blt_mask_scan.argtypes = [i, p, p, i, i, p, p]
        lib.blt_mask_scan.restype = i
        lib.blt_lookup.argtypes = [i, p, p, p, p, i, p]
        lib.blt_lookup.restype = i
        lib.blt_pmxu.argtypes = [i, p, p, p, p, i, i, p]
        lib.blt_pmxu.restype = i
        lib.blt_probe16.argtypes = [i, p, p, i, p]
        lib.blt_probe16.restype = i
        for entry in CTAS_PER_SM.values():
            getattr(lib, entry).argtypes = [ctypes.POINTER(i)]
            getattr(lib, entry).restype = i
        _lib = lib
        return lib


# the occupancy query of each one-launch look-back kernel, by the source
# that holds it, and of the Hopper designs of T13's five lookups (g2d runs
# chain's instantiation), T6's two block-local scans, T12's two mask scans,
# T3's probes (the least of the eight), T10's noscan2 and T5's int16 and
# int8 mixes
CTAS_PER_SM = {
    "token_pass_gap": "blt_token_pass_gap_ctas_per_sm",
    "token_pass": "blt_token_pass_ctas_per_sm",
    "flat_bpe": "blt_flat_packed_ctas_per_sm",
    "lookup_chain": "blt_lookup_chain_ctas_per_sm",
    "lookup_g2d": "blt_lookup_chain_ctas_per_sm",
    "lookup_g2d_flat": "blt_lookup_g2d_flat_ctas_per_sm",
    "lookup_gax0": "blt_lookup_gax0_ctas_per_sm",
    "lookup_g8bit": "blt_lookup_g8bit_ctas_per_sm",
    "scan16": "blt_scan16_ctas_per_sm",
    "swarpack": "blt_swarpack_ctas_per_sm",
    "mask_scan_i32": "blt_mask_scan_i32_ctas_per_sm",
    "mask_scan_bf16": "blt_mask_scan_bf16_ctas_per_sm",
    "probe16": "blt_probe16_ctas_per_sm",
    "row_scan": "blt_row_scan_ctas_per_sm",
    "op_mix16": "blt_op_mix16_ctas_per_sm",
    "op_mix8": "blt_op_mix8_ctas_per_sm",
}


def ctas_per_sm(kernel: str) -> int:
    """CTAs per SM of the current device of ``kernel`` (a key of
    ``CTAS_PER_SM``: the look-back kernel of ``csrc/<stem>.cu``, or T13's
    and T6's kernels), as the CUDA runtime's occupancy query gives them."""
    n = ctypes.c_int(0)
    check(getattr(load(), CTAS_PER_SM[kernel])(ctypes.byref(n)), CTAS_PER_SM[kernel])
    return n.value


def kernel_resources(stem: str) -> dict:
    """Registers, spills and shared memory of each kernel of ``csrc/<stem>.cu``
    as ptxas printed them in this process's compile, by mangled name; empty
    when this process did not compile."""
    out, name = {}, None
    for line in ptxas_log.get(stem, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out.setdefault(name, {})[key] = int(m.group(1))
    return out


def sass_counts(match: str, opcodes: tuple | None) -> dict | None:
    """How many instructions of each of ``opcodes`` (SASS mnemonics, such as
    ``HGMMA`` and ``IGMMA`` for ``wgmma``, ``UBLKCP`` for ``cp.async.bulk``)
    the built library's SASS holds, by kernel (mangled names containing
    ``match``), from ``cuobjdump -sass``; with ``opcodes`` None, every
    opcode's count (the mnemonic before its first dot); None where the
    toolkit has no cuobjdump."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(build())], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                out[name] = dict.fromkeys(opcodes or (), 0)
        elif name and opcodes is None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                out[name][m.group(1)] = out[name].get(m.group(1), 0) + 1
        elif name:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    out[name][op] += 1
    return out


# one lock for every module's launch counters: requests on several threads
# launch at once, and ``launches[name] += k`` is a read and then a write
_count_lock = threading.Lock()


def count(launches: dict, name: str, k: int = 1) -> None:
    """Add ``k`` to ``launches[name]``; a wrapper calls it where it launches."""
    with _count_lock:
        launches[name] += k


def reset_counts(launches: dict) -> None:
    """Set every count of ``launches`` to 0."""
    with _count_lock:
        for name in launches:
            launches[name] = 0


def check(err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


if __name__ == "__main__":
    print(build())
