"""Reading a ``torch.profiler`` Chrome trace of the measured window.

The harness marks the window and each job with ``record_function`` ranges
(``WINDOW``, ``JOB``); device activity is clipped to the window. Kernels are
named by their demangled function and first parameter's type.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Tuple

WINDOW = "h100_bench.window"
JOB = "h100_bench.job"
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function"}
_QUALIFIED = re.compile(r"[A-Za-z_][\w:]*")


@dataclass
class Trace:
    window: Tuple[float, float]  # microseconds
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # name, ts, dur
    copies: List[Tuple[str, float, float, int]] = field(default_factory=list)  # + bytes
    memsets: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float, int]] = field(default_factory=list)  # + tid

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def clip(self, ts: float, dur: float) -> float:
        """Microseconds of [ts, ts + dur] inside the window."""
        return max(0.0, min(ts + dur, self.window[1]) - max(ts, self.window[0]))

    def device_intervals(self) -> List[Tuple[float, float]]:
        return [(ts, ts + d) for _, ts, d in self.kernels] + \
               [(ts, ts + d) for _, ts, d, _ in self.copies] + \
               [(ts, ts + d) for _, ts, d in self.memsets]


def parse(events: Iterable[dict]) -> Trace:
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW} range")
    w = windows[0]
    t = Trace((float(w["ts"]), float(w["ts"]) + float(w["dur"])))
    for e in events:
        cat, name, ts, dur = e.get("cat"), e.get("name", ""), float(e["ts"]), float(e["dur"])
        if cat == "kernel":
            t.kernels.append((name, ts, dur))
        elif cat == "gpu_memcpy":
            t.copies.append((name, ts, dur, int(e.get("args", {}).get("bytes", 0))))
        elif cat == "gpu_memset":
            t.memsets.append((name, ts, dur))
        elif cat in HOST_CATS and name != WINDOW:
            t.host.append((name, ts, dur, int(e.get("tid", 0)) if str(e.get("tid", 0)).isdigit() else 0))
    return t


def load(path: Path) -> Trace:
    with open(path) as f:
        return parse(json.load(f)["traceEvents"])


def merged(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` inside [lo, hi], as sorted disjoint pieces."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(t: Trace) -> float:
    """Seconds of the window in which any kernel, copy or memset ran."""
    return sum(b - a for a, b in merged(t.device_intervals(), *t.window)) / 1e6


def qualified(kernel: str) -> str:
    """A demangled kernel name's function, namespaces kept, the anonymous
    namespace, return type, template arguments and parameters dropped."""
    s = kernel[5:] if kernel.startswith("void ") else kernel
    m = _QUALIFIED.match(s.replace("(anonymous namespace)::", ""))
    return m.group(0) if m else s


def _first_parameter(kernel: str) -> str:
    """The type of a demangled kernel's first parameter ("" for none)."""
    if not kernel.endswith(")"):
        return ""
    depth = 0
    for i in range(len(kernel) - 1, -1, -1):  # the parameter list's opening
        depth += {")": 1, "(": -1}.get(kernel[i], 0)
        if depth == 0:
            break
    params, depth = kernel[i + 1 : -1], 0
    for j, c in enumerate(params):
        depth += {"<": 1, "(": 1, ">": -1, ")": -1}.get(c, 0)
        if c == "," and depth == 0:
            return params[:j].strip()
    return params.strip()


def short(kernel: str) -> str:
    """A kernel's function with its first parameter's type, enough to tell
    apart two functions of one name in two files."""
    q = qualified(kernel).rsplit("::", 1)[-1]
    first = _first_parameter(kernel)
    return f"{q}({first[:40]})" if first else q


def kernel_seconds(t: Trace, which=lambda name: True) -> float:
    return sum(t.clip(ts, d) for name, ts, d in t.kernels if which(name)) / 1e6


def device_ops(t: Trace, top: int = 10) -> List[List]:
    """The device operations that took most of the window, by name."""
    total: dict = defaultdict(float)
    for name, ts, d in t.kernels:
        total[short(name)] += t.clip(ts, d)
    for name, ts, d, _ in t.copies:
        total[name] += t.clip(ts, d)
    for name, ts, d in t.memsets:
        total[name] += t.clip(ts, d)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, us / 1e6] for name, us in ranked if us > 0]


def _host_at(t: Trace, when: float) -> str:
    """What the host was doing at ``when``: on each thread the innermost
    traced range that holds it, the job range aside. The profiler sees CUDA
    calls on every thread but PyTorch operators only on some, so "no traced
    call" is host work of Python or native code; "between jobs" outside any
    job."""
    inner: dict = {}
    in_job = False
    for name, ts, d, tid in t.host:
        if ts <= when <= ts + d:
            if name == JOB:
                in_job = True
            elif tid not in inner or d < inner[tid][1]:
                inner[tid] = (name, d)
    names = sorted({n for n, _ in inner.values()})
    what = " + ".join(names) if names else "no traced call"
    return what if in_job else f"between jobs: {what}"


def idle_gaps(t: Trace, top: int = 10) -> List[List]:
    """The longest stretches of the window with nothing on the device, each
    named by what the host was doing in its middle and by the device
    operation that ended last before it."""
    ops = sorted([(ts + d, short(n)) for n, ts, d in t.kernels] +
                 [(ts + d, n) for n, ts, d, _ in t.copies] + [(ts + d, n) for n, ts, d in t.memsets])
    ends = [e for e, _ in ops]
    busy = merged(t.device_intervals(), *t.window)
    edges = [t.window[0]] + [x for iv in busy for x in iv] + [t.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        k = bisect.bisect_right(ends, a + 1e-3) - 1
        after = ops[k][1] if k >= 0 else "the window's start"
        out.append([f"{_host_at(t, (a + b) / 2)}, after {after}", (b - a) / 1e6])
    return out


def d2h(t: Trace) -> Tuple[int, float]:
    """(bytes, seconds) of the device-to-host copies in the window."""
    nbytes, us = 0, 0.0
    for name, ts, d, b in t.copies:
        if "DtoH" in name and t.clip(ts, d) > 0:
            nbytes += b
            us += d
    return nbytes, us / 1e6

