"""What the device-rate tools and ``chip_smoke.py`` share: the corpus and its
frequent-pair table, the chain timer, the wall-clock timer of the loop
tools, rate statistics, the byte bound, the NumPy merge round and the card's
description.

The corpus recipe and ``rate_stats`` are copies of ``bench.py``'s
(``make_corpus``, ``rate_stats``), without its on-disk cache: the corpus is
made from a seed on every run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from blt_tpu_torch.merges import NO_RULE, MergeTable
from blt_tpu_torch.ops.bpe_cuda import chain_passes
from blt_tpu_torch.ops.bpe_numpy import _merge_starts, _pair_values_sparse

MIB = 1 << 20
LANES = 128
RULES = 500
REPS = 5  # timed samples of each chain (bench.py's REPS)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SMS = 132  # streaming multiprocessors of an H100 SXM
# an SM issues at most one 32-lane warp instruction per scheduler (4) per
# clock, whatever its type: the integer peak taken here. It is the lane count
# behind the data sheet's 67 TFLOP/s of float32 (132 x 128 x 2 x 1.98 GHz);
# the data sheet gives no rate for integer operations outside the tensor cores.
LANES_ISSUED_PER_SM = 128
BOOST_SM_MHZ = 1980  # H100 SXM maximum SM clock (data sheet), where no card says
# H100 SXM dense tensor-core peaks, without sparsity (NVIDIA data sheet)
TENSOR_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def make_corpus(rng: np.random.Generator, n: int) -> np.ndarray:
    """Zipf-ish text bytes: a 4 MiB base sample, tiled and rotated to ``n``."""
    alphabet = np.frombuffer(
        b"etaoinshrdlucmfwypvbgkjqxz ETAOIN,.;:'\"!?0123456789", np.uint8
    )
    weights = 1.0 / np.arange(1, len(alphabet) + 1)
    base_n = 4 * MIB
    base = rng.choice(alphabet, size=base_n, p=weights / weights.sum()).astype(np.uint8)
    reps = -(-n // base_n)
    shift = int(rng.integers(0, base_n))
    return np.roll(np.tile(base, reps)[:n], shift)


def frequent_pairs(corpus: np.ndarray, k: int = RULES) -> list:
    """The k most frequent byte pairs of the corpus's first 4 MiB, most
    frequent first."""
    sample = corpus[: 4 * MIB]
    pairs, counts = np.unique(
        sample[:-1].astype(np.int32) * 256 + sample[1:].astype(np.int32),
        return_counts=True,
    )
    top = pairs[np.argsort(-counts, kind="stable")][:k]
    return [(int(p) // 256, int(p) % 256) for p in top]


def frequent_pair_table(corpus: np.ndarray) -> MergeTable:
    """The tools' and bench's table: the ``RULES`` most frequent pairs,
    numbered 256, 257, ... by frequency."""
    return MergeTable.build({p: 256 + i for i, p in enumerate(frequent_pairs(corpus))})


def rate_stats(rates) -> dict:
    """Median and spread of per-sample values (a copy of ``bench.py``'s)."""
    r = np.asarray(sorted(rates), dtype=np.float64)
    q1, med, q3 = np.percentile(r, [25, 50, 75])
    return {"median": float(med), "iqr": float(q3 - q1), "min": float(r[0]),
            "max": float(r[-1]), "n": int(r.size)}


def bound_ms(nbytes: int) -> float:
    """Least time to move ``nbytes`` (inputs read once, outputs written
    once) at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def ops_bound_ms(ops: int, sm_mhz: float) -> float:
    """Least time for ``ops`` 32-bit integer operations, one per lane the
    card's SMs issue per clock at ``sm_mhz``."""
    return ops / (SMS * LANES_ISSUED_PER_SM * sm_mhz * 1e6) * 1e3


def tensor_bound_ms(ops: int, dtype: str) -> float:
    """Least time for ``ops`` tensor-core operations (a multiply-add counts
    two) in ``dtype`` ("bf16" or "int8") at the card's dense peak."""
    return ops / TENSOR_OPS_PER_S[dtype] * 1e3


def sm_clock_mhz(device: torch.device) -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``), or the
    data sheet's on the CPU."""
    if device.type != "cuda":
        return BOOST_SM_MHZ
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def describe(device: torch.device) -> dict:
    """What the numbers were measured on."""
    if device.type != "cuda":
        return {"type": device.type}
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": nvidia_smi()}


def _timed(fn, device: torch.device):
    """(seconds, result) of one ``fn()``: CUDA events on a card, the host
    clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3, out


def _sample_stats(seconds, k: int, in_bytes: int) -> dict:
    return {"ms_per_launch": rate_stats([s * 1e3 / k for s in seconds]),
            "GB_per_s": rate_stats([in_bytes * k / s / 1e9 for s in seconds])}


def equal(a, b) -> bool:
    """Two tuples of tensors, element for element, exactly."""
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def time_chain(run, k: int, in_bytes: int, device: torch.device, expect) -> dict:
    """Time ``run()``, which enqueues k launches with no host sync, ``REPS``
    times: as launched (``eager``), and on a card also replayed from a
    ``torch.cuda.CUDAGraph`` captured from one ``run()`` (``graph``). Rates
    are input bytes (``in_bytes`` per launch) times k over the seconds,
    bench.py's N·k/dt. ``exact``: the last timed run's result and the
    replayed graph's both equal ``expect``, a tuple of tensors.

    The wrappers count a launch when they are called, so a captured chain
    adds its k launches once, at capture; replays add none.
    """
    run()  # warm-up: builds the library and loads the kernels before capture
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    eager, out = [], None
    for _ in range(REPS):
        out = None  # free the last result first, so the allocator reuses it
        seconds, out = _timed(run, device)
        eager.append(seconds)
    result = {"k": k, "eager": _sample_stats(eager, k, in_bytes),
              "graph": None, "exact": equal(out, expect)}
    del out
    if device.type == "cuda":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            kept = run()  # lives in the graph's pool; each replay rewrites it
        graph.replay()
        torch.cuda.synchronize(device)
        replays = [_timed(graph.replay, device)[0] for _ in range(REPS)]
        result["graph"] = _sample_stats(replays, k, in_bytes)
        result["exact"] = result["exact"] and equal(kept, expect)
        del graph, kept
    return result


def chain_by_carry(pass_fn, carry, k: int):
    """``chain_passes(pass_fn, carry, k)`` for a pass whose result depends on
    its input carry alone, which is 0 or 1: at most two passes run."""
    seen = {}

    def link(c):
        key = int(c)
        if key not in seen:
            seen[key] = pass_fn(c)
        return seen[key]

    return chain_passes(link, carry, k)


def repeat(fn, k: int):
    """``fn()`` k times back to back; the last result."""
    return chain_passes(lambda _: (fn(), None), None, k)[0]


def chained_ms(fn, k: int, in_bytes: int, device: torch.device, expect) -> float:
    """Median ms per call of ``fn()`` called k times back to back, timed as
    the kernels' chains are (the graph replay on a card): the yardstick of
    one library call beside a kernel's chain. Raises when its result
    differs from ``expect``."""
    t = time_chain(lambda: repeat(fn, k), k, in_bytes, device, expect)
    if not t["exact"]:
        raise RuntimeError("the library call's result differs from its expected value")
    return (t["graph"] or t["eager"])["ms_per_launch"]["median"]


def median_ms(fn, device: torch.device, reps: int = 3) -> float:
    """Median milliseconds of one ``fn()`` after one warm-up call."""
    fn()
    return statistics.median(_timed(fn, device)[0] for _ in range(reps)) * 1e3


def read_count(out) -> int:
    """The loop tools' force: the count of a call's result (its second
    element) read on the host."""
    return int(out[1])


def time_wall(fn, in_bytes: int, device: torch.device, reps: int = REPS, pipe: int = 1,
              force=read_count, warm: bool = True):
    """The loop tools' wall-clock protocol (the originals'): after one
    warm-up call (``warm``), ``reps`` samples of ``pipe`` calls of ``fn()``
    back to back on the host clock, each sample ended by ``force`` on the
    last call's result (None: nothing to read) and, on a card, a
    synchronize. Returns (timing, the last result): the timing holds ms per
    call and MB/s (``in_bytes`` a call, 1e6 bytes) as ``rate_stats``."""
    if warm:
        fn()
    ms, rates, out = [], [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(pipe):
            out = None  # free the last result first, so the allocator reuses it
            out = fn()
        if force is not None:
            force(out)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = (time.perf_counter() - t0) / pipe
        ms.append(seconds * 1e3)
        rates.append(in_bytes / seconds / 1e6)
    return {"reps": reps, "pipe": pipe, "ms": rate_stats(ms),
            "MB_per_s": rate_stats(rates)}, out


def wall_row(name: str, kernel, timing: dict, bound_bytes: int, exact: bool, **extra) -> dict:
    """A row timed by the wall clock: ``timing`` from ``time_wall``, the
    bytes the function must move over the card's memory rate."""
    return {"name": name, "kernel": kernel, "rpb": None, **extra, "exact": bool(exact),
            "wall": timing, "bound_ms": bound_ms(bound_bytes), "bound_by": "bytes"}


@contextlib.contextmanager
def env(name: str, value: str):
    """``os.environ[name] = value`` inside the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def pass_host(tokens: np.ndarray, table: MergeTable) -> np.ndarray:
    """One merge round in NumPy (``bpe_numpy``'s steps): the merged value
    at a merge start, -1 at the position it consumed, else the token: the
    function of K4 over ``tokens`` (int32, all valid)."""
    tokens = tokens.astype(np.int32, copy=False)
    if tokens.shape[0] < 2:
        return tokens.copy()
    pair_vals = _pair_values_sparse(tokens, table)
    starts = _merge_starts(pair_vals != NO_RULE)
    out = np.where(np.append(starts, False), np.append(pair_vals, NO_RULE), tokens)
    out[1:][starts] = -1
    return out.astype(np.int32, copy=False)


def rounds_host(tokens: np.ndarray, table: MergeTable):
    """The multipass loop in NumPy, round by round (``pass_host``, then
    the survivors): (the final tokens, the live counts before the first
    round and after each). The loop stops after a round that merges
    nothing, or at one token left, as the encoders' loops do."""
    toks = tokens.astype(np.int32)
    counts = [int(toks.shape[0])]
    while toks.shape[0] > 1:
        out = pass_host(toks, table)
        kept = out[out != -1]
        counts.append(int(kept.shape[0]))
        if kept.shape[0] == toks.shape[0]:
            break
        toks = kept
    return toks, counts


def loop_bytes(counts) -> int:
    """The bytes a multipass loop must move: each round reads its live int32
    tokens and writes the survivors, once each."""
    return sum(4 * (a + b) for a, b in zip(counts, counts[1:]))


def parser(description: str, k: int, size_mib: int = 64,
           k_means: str = "launches per chain") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    ap.add_argument("--size-mib", type=int, default=size_mib,
                    help=f"input size in MiB (default {size_mib}, the original's)")
    ap.add_argument("--k", type=int, default=k, help=f"{k_means} (default {k})")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def device_of(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass --device cpu")
    return device


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
