"""One run of one cell of the benchmark of ``blt_tpu_torch`` on NVIDIA GPUs.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs and merge table from the seed, builds the
program's entry (one ``ByteTokenizer`` a run, or ``cli.main`` a job) and
runs one small warm-up job. The window then runs jobs one after another, a
job being one file tokenized to a sink the harness reads, and closes at the
end of the first job that ends after ``--seconds``. With ``--trace 1`` the
window runs under ``torch.profiler`` and the cell's per-layer metrics are
read from the trace and the program's counters; with ``--trace 0`` its
end-to-end metrics are read by the host clock.

After the window every job's whole output is judged against the plain
reference (``reference/``) on the card. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``), with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared with
its limit; the checks are also the last lines of standard error. Earlier
lines give the card's power limit and clocks, the set-up's parts, the
program's launch counts, its loop's rounds and compactions per chunk, its
stage times, the peak device memory and the reference's seconds.

``--control 1`` puts the control (``reference/control.py``) in the
program's place; it has to come out as not correct. The benchmark's own
runs leave it at 0.

Exits 1 with no result without a CUDA device (or fewer than the cell asks
for), without the program, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is in ``sys.modules`` once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional, Tuple  # noqa: E402

# top-level module names a run may not hold: JAX, flax and the JAX package
# with its benchmarks, compared whole (``blt_tpu_torch`` is not ``blt_tpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "blt_tpu", "bench", "benches")
API_TYPES = {"text": "Text", "bin": "Bin"}  # ByteTokenizer's content types


def _process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


_AGE0 = _process_age()


def setup_seconds() -> float:
    return _AGE0 + time.perf_counter() - _T0


def environment(root: Path) -> None:
    """The program's default path, and its caches inside the checkout at
    fixed paths: the port's own builds go to ``build/blt_tpu_torch/``."""
    for key in [k for k in os.environ if k.startswith("BLT_")] + ["RUST_LOG"]:
        os.environ.pop(key, None)
    cache = root / "build" / "h100_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"  # keeps transformers, if ever imported, off JAX


def chunk_bytes(size: Optional[str]) -> Optional[int]:
    """``blt``'s size strings: digits, optionally KB or MB (1024-based)."""
    if size is None:
        return None
    s = size.strip().upper()
    for unit, mult in (("KB", 1 << 10), ("MB", 1 << 20)):
        if s.endswith(unit):
            return int(s[: -len(unit)]) * mult
    return int(s)


class Program:
    """The system under test: the port's entry points and its counters."""

    def __init__(self) -> None:
        from blt_tpu_torch import api, cli
        from blt_tpu_torch.ops import bpe_cuda, multipass_cuda
        from blt_tpu_torch.pipeline import feeder

        self.api, self.cli, self.feeder = api, cli, feeder
        self.counted = (bpe_cuda, multipass_cuda)
        self.multipass = multipass_cuda
        self.merges = None  # the CLI's merges file
        self.tokenizer = None

    def entry(self, traffic: dict, config: dict, table) -> Callable[[str, str], None]:
        ct = traffic["content_type"]
        if traffic["entry"] == "api":
            self.tokenizer = tok = self.api.ByteTokenizer(
                merges=table.rules, content_type=API_TYPES[ct], chunk_size=config.get("chunk_size"),
                threads=config.get("threads"))
            return tok.tokenize_file
        if traffic["entry"] == "cli":
            from h100_bench.common import recipes, traffic as gen

            if table.pairs is None:
                raise ValueError("a merges file holds byte pairs only; this table has token keys")
            self.merges = gen.memory_file_of("h100_bench_merges", recipes.merges_text(table.pairs))
            args = ["--merges", self.merges.path, "--type", ct]
            if config.get("chunk_size"):
                args += ["--chunksize", config["chunk_size"]]
            if config.get("threads"):
                args += ["--threads", str(config["threads"])]

            def job(inp: str, out: str) -> None:
                rc = self.cli.main(["-i", inp, "-o", out, *args])
                if rc != 0:
                    raise RuntimeError(f"cli.main returned {rc}")

            return job
        raise ValueError(f"unknown entry {traffic['entry']!r}")

    def reset(self) -> None:
        self.feeder.stage_stats(reset=True)
        for m in self.counted:
            m.reset_launches()

    def stages(self) -> dict:
        return self.feeder.stage_stats()

    def counts(self) -> Tuple[dict, list]:
        launches = {k: v for m in self.counted for k, v in m.launches.items() if v}
        return launches, list(self.multipass.loop_log)

    def close(self) -> None:
        self.tokenizer = None
        if self.merges is not None:
            os.close(self.merges.fd)
            self.merges = None


class Control:
    """The control in the program's place: the reference with one stated
    guarantee broken (``reference/control.py``), written to the same sink."""

    def __init__(self, device, chunk: Optional[int], header: int) -> None:
        self.device, self.chunk, self.header = device, chunk, header

    def entry(self, traffic: dict, config: dict, table) -> Callable[[str, str], None]:
        import numpy as np
        import torch

        from h100_bench.reference.control import Control as Broken

        broken = Broken(table.rules, self.chunk, self.device)

        def job(inp: str, out: str) -> None:
            data = np.fromfile(inp, dtype=np.uint8)
            with open(out, "wb") as f:
                f.write(self.header.to_bytes(2, "big"))
                for t in broken.encode(data):
                    be = torch.stack([(t >> 8) & 0xFF, t & 0xFF], dim=1).to(torch.uint8)
                    f.write(be.cpu().numpy().tobytes())

        return job

    def reset(self) -> None:
        pass

    def stages(self) -> dict:
        return {}

    def counts(self) -> Tuple[dict, list]:
        return {}, []

    def close(self) -> None:
        pass


def card(device) -> str:
    """The card's name, power limit and clocks, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def _cpu_seconds() -> float:
    """This process's CPU seconds, all its threads together."""
    t = os.times()
    return t.user + t.system


def _window(job, inputs, sink, seconds: float, traced: bool, device, stages):
    """Jobs one after another until the first that ends after ``seconds``:
    (jobs, start, the trace's path or None, the program's stage times
    after each job)."""
    import torch

    from h100_bench.common import trace as tr
    from h100_bench.common.window import Job

    jobs: List[Job] = []
    after: List[dict] = []
    cpu = [_cpu_seconds()]
    order = inputs.order()
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function(tr.WINDOW):
            start = time.perf_counter()
            while True:
                i = next(order)
                f = inputs.files[i]
                with torch.profiler.record_function(tr.JOB):
                    t0 = time.perf_counter()
                    path = sink.start(i, 2 * f.size + 2)
                    error = None
                    try:
                        job(f.path, path)
                    except Exception as e:  # a failed job is counted, and the window goes on
                        error = f"{type(e).__name__}: {e}"
                    out = sink.finish()
                    t1 = time.perf_counter()
                jobs.append(Job(i, t0, t1, f.size, out.nbytes, error, out.same, out.overflow))
                after.append(stages())
                if t1 - start >= seconds:
                    break
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            cpu.append(_cpu_seconds())
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    path = None
    if prof is not None:
        fd, path = tempfile.mkstemp(prefix="h100_bench_trace_", suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(path)
    return jobs, start, path, after, cpu


def _busy_by_job(after: List[dict]) -> dict:
    """Each stage's busy seconds in each job: its producing time less its
    wait on the stage above it (the feed waits on none)."""
    out = {}
    for name in ("feed", "d2h", "drain"):
        if not after or name not in after[-1]:
            continue
        up = None if name == "feed" else ("d2h" if "d2h" in after[-1] and name == "drain" else "feed")
        total = [a.get(name, {}).get("src_time", 0.0) - (a.get(up, {}).get("get_wait", 0.0) if up else 0.0)
                 for a in after]
        out[name] = [round(y - x, 3) for x, y in zip([0.0] + total[:-1], total)]
    return out


def _spread(values) -> str:
    if not values:
        return "none"
    return f"min {min(values)} median {statistics.median(values)} max {max(values)} n {len(values)}"


def run(cell, seed: int, seconds: float, traced: bool, device, control: bool = False,
        root: Optional[Path] = None):
    """One run of ``cell``: (the result's object, the earlier lines)."""
    import torch

    from h100_bench import manifest
    from h100_bench.common import trace as tr
    from h100_bench.common.sink import Sink
    from h100_bench.common.traffic import Inputs
    from h100_bench.common.window import Window
    from h100_bench.reference import bpe, judge

    root = root or manifest.ROOT
    cuda = device.type == "cuda"
    notes: List[str] = []
    parts = {}
    chunk = chunk_bytes(cell.config.get("chunk_size"))
    header = bpe.HEADER_TOKENS[cell.traffic["content_type"]]
    program = Control(device, chunk, header) if control else Program()
    c = time.perf_counter()
    inputs = Inputs(cell.traffic, seed, device)
    parts["inputs_s"] = time.perf_counter() - c
    c = time.perf_counter()
    spec = cell.config["table"]
    table = manifest.recipe(spec["recipe"], root).build(spec, seed, device)
    parts["table_s"] = time.perf_counter() - c
    if chunk is None and not bpe.is_flat(table.rules):
        raise ValueError("a general table needs the configuration's chunk_size")

    sink = Sink()
    try:
        c = time.perf_counter()
        job = program.entry(cell.traffic, cell.config, table)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        path = sink.start(-1, 2 * inputs.warmup.size + 2)
        try:
            job(inputs.warmup.path, path)
        finally:
            sink.finish()
            sink.forget(-1)
        if cuda:
            torch.cuda.synchronize(device)
        parts["program_and_warmup_s"] = time.perf_counter() - c
        program.reset()

        for i, f in enumerate(inputs.files):
            sink.prepare(i, 2 * f.size + 2)
        setup_s = setup_seconds()
        jobs, start, trace_path, after, cpu = _window(job, inputs, sink, seconds, traced, device,
                                                 program.stages)
    finally:
        sink.close()
    stages = program.stages()
    launches, loops = program.counts()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    notes.append(f"card: {card(device)}")
    del job
    program.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    c = time.perf_counter()
    reference = bpe.Reference(table.rules, chunk, device)
    wrong_of = {}
    for key, stream in sorted(sink.kept.items()):
        wrong_of[key], first = judge.wrong_tokens(
            stream, header, reference.encode(inputs.files[key].data), device)
        if wrong_of[key]:
            notes.append(f"input {key}: {wrong_of[key]} tokens wrong, the first at token {first}")
    reference_s = time.perf_counter() - c
    bad = [j for j in jobs if j.error or j.overflow or j.same is False or wrong_of.get(j.index)]
    for j in bad[:5]:
        notes.append(f"job on input {j.index} wrong: error {j.error}, same as kept {j.same}, "
                     f"overflow {j.overflow}")
    checks = {"jobs_wrong": {"value": len(bad), "limit": judge.LIMITS["jobs_wrong"]},
              "tokens_wrong": {"value": sum(wrong_of.values()), "limit": judge.LIMITS["tokens_wrong"]}}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    window = Window(start, jobs, setup_s, stages)
    if trace_path is not None:
        try:
            window.trace = tr.load(Path(trace_path))
        finally:
            os.unlink(trace_path)
    metrics = manifest.read_metrics(cell.per_layer if traced else cell.end_to_end, window, root)

    times = [j.end - j.start for j in jobs]
    notes.append(f"set-up: {setup_s} s, of it {json.dumps(parts)}")
    notes.append(f"window: {window.seconds} s, {len(jobs)} jobs, {sum(j.in_bytes for j in jobs)} bytes in, "
                 f"{sum(j.out_bytes for j in jobs)} bytes out; job seconds {_spread(times)}")
    notes.append(f"job seconds in order: {[round(t, 3) for t in times[:40]]}")
    notes.append(f"stage busy seconds by job: {json.dumps(_busy_by_job(after[:40]))}")
    notes.append(f"host load average at the window's end: {os.getloadavg()}")
    if len(cpu) == 2:
        notes.append(f"CPU seconds of this process over the window: {cpu[1] - cpu[0]:.3f} "
                     f"({os.cpu_count()} CPUs)")
    notes.append(f"launches: {json.dumps(launches, sort_keys=True)}")
    notes.append(f"rounds a chunk: {_spread([r for r, _ in loops])}; "
                 f"compactions a chunk: {_spread([k for _, k in loops])}")
    notes.append(f"stages: {json.dumps(stages, sort_keys=True)}")
    notes.append(f"memory_peak_bytes: {peak}")
    notes.append(f"reference: {reference_s} s over {len(sink.kept)} inputs")
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(jobs), "failed": len(bad), "metrics": metrics,
              "device": dev}
    if window.trace is not None:
        t = window.trace
        dev["busy_s"] = tr.busy_s(t)
        dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(t), "idle_gaps": tr.idle_gaps(t)}
    inputs.close()
    result["checks"] = checks
    return result, notes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from h100_bench import manifest

    environment(manifest.ROOT)
    try:
        cell = manifest.cell(manifest.load(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100_bench: the cell needs {cell.chips} CUDA device(s); this process sees {n}",
              file=sys.stderr)
        return 1
    try:
        result, notes = run(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), control=bool(args.control))
    except ImportError as e:
        print(f"h100_bench: the program is not importable: {e}", file=sys.stderr)
        return 1
    found = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"h100_bench: the run loaded {found}; the port and the harness may not", file=sys.stderr)
        return 1
    for line in notes:
        print(line)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
