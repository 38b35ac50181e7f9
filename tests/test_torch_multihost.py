"""The port's multi-process runner against the JAX package's, on the CPU.

- The bounds planners (``even_bounds``, ``chunk_aligned_bounds``,
  ``safe_split_bounds``, ``plan_bounds``) against ``blt_tpu.parallel
  .multihost``'s on random inputs, the all-match case included.
- ``_Spool`` spilling past its budget, and single-process runs of
  ``run_tokenizer_distributed`` (encode and decode, with their errors).
- Two real processes over gloo on 127.0.0.1, through the runner's
  multi-process branch (``BLT_COORDINATOR_ADDRESS`` / ``BLT_NUM_PROCESSES``
  / ``BLT_PROCESS_ID``): basic, flat BPE, hierarchical BPE, passthrough
  and decode, each with the NumPy engine, the torch engine on a CPU row
  and the shard engine on two CPU rows. Each output must equal the
  single-process port run and the JAX package's ``run_tokenizer`` on the
  same file, byte for byte. The pair of processes runs every job once (one
  process group), each process under a 120 s timeout.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from blt_tpu.config import ContentType as JaxContentType
from blt_tpu.config import CoreConfig as JaxConfig
from blt_tpu.config import Engine as JaxEngineName
from blt_tpu.merges import MergeTable as JaxMergeTable
from blt_tpu.parallel import multihost as jax_multihost
from blt_tpu.pipeline.runner import run_tokenizer as jax_run_tokenizer
from blt_tpu_torch.config import ContentType, CoreConfig
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops.decode import DecodeError
from blt_tpu_torch.parallel import multihost
from blt_tpu_torch.pipeline.runner import run_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (32, 97): 259}
HIER = {(97, 98): 256, (256, 99): 257, (257, 257): 258, (32, 256): 259}


def _data(seed, n, alphabet=b"abcabc ab c"):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


def _merges_file(path, merges=MERGES):
    path.write_text("".join(f"{a} {b}\n" for a, b in merges))
    return path


# --- bounds ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_bounds_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        total = int(rng.integers(0, 10**7))
        n = int(rng.integers(1, 9))
        chunk = int(rng.integers(1, 1 << 22))
        assert multihost.even_bounds(total, n) == jax_multihost.even_bounds(total, n)
        assert (multihost.chunk_aligned_bounds(total, chunk, n)
                == jax_multihost.chunk_aligned_bounds(total, chunk, n))
    table, jtable = MergeTable.build(MERGES), JaxMergeTable.build(MERGES)
    mm = _data(seed, int(rng.integers(1, 300_000)), b"abcabcaab c")
    for n in (1, 2, 3, 5, 8):
        bounds = multihost.safe_split_bounds(mm, table.dense, n)
        assert bounds == jax_multihost.safe_split_bounds(mm, jtable.dense, n)
        for j in bounds[1:-1]:
            if 0 < j < mm.shape[0]:
                assert table.dense[int(mm[j - 1]) * 256 + int(mm[j])] == -1


def test_safe_split_bounds_all_matches_match_jax():
    table, jtable = MergeTable.build({(97, 97): 256}), JaxMergeTable.build({(97, 97): 256})
    mm = np.full(10_000, 97, np.uint8)
    bounds = multihost.safe_split_bounds(mm, table.dense, 4)
    assert bounds == jax_multihost.safe_split_bounds(mm, jtable.dense, 4)
    assert bounds[0] == 0 and all(b == mm.shape[0] for b in bounds[1:])


@pytest.mark.parametrize("merges,chunksize", [(None, None), (MERGES, None), (HIER, "256KB"),
                                              (HIER, None)])
def test_plan_bounds_match_jax(tmp_path, merges, chunksize):
    mm = _data(7, 900_001)
    cfg = CoreConfig.new_from_cli(chunksize=chunksize)
    jcfg = JaxConfig.new_from_cli(chunksize=chunksize)
    if merges is not None:
        cfg.with_merges(merges)
        jcfg.with_merges(merges)
    assert multihost.dist_chunk_size(cfg) == jax_multihost.dist_chunk_size(jcfg)
    for n in (1, 2, 3, 4):
        assert (multihost.plan_bounds(cfg, mm.shape[0], mm, n)
                == jax_multihost.plan_bounds(jcfg, mm.shape[0], mm, n))


def test_incomplete_environment_raises(monkeypatch):
    monkeypatch.setenv("BLT_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.delenv("BLT_PROCESS_ID", raising=False)
    monkeypatch.setenv("BLT_NUM_PROCESSES", "2")
    assert multihost.env_distributed()
    with pytest.raises(ValueError, match="BLT_PROCESS_ID"):
        multihost.initialize_from_env()


# --- single process ------------------------------------------------------------


def test_single_process_runner_matches_and_truncates(tmp_path):
    data = _data(3, 300_000)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    mp = _merges_file(tmp_path / "m.txt")
    for merges in (None, mp):
        out, ref = tmp_path / "dist.bin", tmp_path / "ref.bin"
        out.write_bytes(b"\xee" * 2_000_000)  # stale, longer output: truncated
        multihost.run_tokenizer_distributed(
            CoreConfig.new_from_cli(input=src, output=out, merges=merges), "numpy")
        run_tokenizer(CoreConfig.new_from_cli(input=src, output=ref, merges=merges),
                      engine="numpy")
        assert out.read_bytes() == ref.read_bytes(), merges
    with pytest.raises(ValueError, match="file input"):
        multihost.run_tokenizer_distributed(CoreConfig.new_from_cli(output=out))


def test_spool_spills_past_its_budget(tmp_path, monkeypatch):
    spills = []
    real_spill = multihost._Spool._spill

    def spy(self):
        spills.append(self.bytes)
        return real_spill(self)

    monkeypatch.setattr(multihost, "_spool_budget", lambda cfg: 10_000)
    monkeypatch.setattr(multihost._Spool, "_spill", spy)
    data = _data(6, 300_000)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    mp = _merges_file(tmp_path / "m.txt")
    out, ref = tmp_path / "dist.bin", tmp_path / "ref.bin"
    multihost.run_tokenizer_distributed(
        CoreConfig.new_from_cli(input=src, output=out, merges=mp), "numpy")
    jax_run_tokenizer(JaxConfig.new_from_cli(input=src, output=ref, merges=mp,
                                             engine=JaxEngineName.NUMPY))
    assert out.read_bytes() == ref.read_bytes()
    assert spills  # the budget forced a spill
    assert not list(tmp_path.glob(".blt_spool_*"))


def test_single_process_decode_and_its_errors(tmp_path):
    data = _data(4, 200_000)
    src, wire, out = tmp_path / "in.bin", tmp_path / "wire.bin", tmp_path / "back.bin"
    src.write_bytes(data.tobytes())
    mp = _merges_file(tmp_path / "m.txt")
    run_tokenizer(CoreConfig.new_from_cli(input=src, output=wire, merges=mp,
                                          content_type=ContentType.TEXT), engine="numpy")
    out.write_bytes(b"\xee" * 1_000_000)
    multihost.run_tokenizer_distributed(CoreConfig.new_from_cli(
        input=wire, output=out, merges=mp, content_type=ContentType.TEXT, decode=True))
    assert out.read_bytes() == data.tobytes()
    wb = wire.read_bytes()
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes([0xFF, 0x03]) + wb[2:])
    with pytest.raises(DecodeError, match="expected content-type header"):
        multihost.run_tokenizer_distributed(CoreConfig.new_from_cli(
            input=bad, output=out, merges=mp, content_type=ContentType.TEXT, decode=True))
    odd = tmp_path / "odd.bin"
    odd.write_bytes(wb + b"\x00")
    with pytest.raises(DecodeError, match="odd trailing byte"):
        multihost.run_tokenizer_distributed(CoreConfig.new_from_cli(
            input=odd, output=out, decode=True))
    with pytest.raises(DecodeError, match="invalid token"):
        multihost.run_tokenizer_distributed(CoreConfig.new_from_cli(
            input=wire, output=out, content_type=ContentType.TEXT, decode=True))
    assert out.read_bytes() == data.tobytes()
    assert not list(tmp_path.glob(".blt_spool_*"))


# --- two real processes --------------------------------------------------------

# Every job of one process: (name, mode, engine, input, merges file or
# rules, chunk size). The worker joins the group through the runner's
# multi-process branch, and checks that it was one of two processes.
_WORKER = textwrap.dedent(
    """
    import json, sys, torch
    from pathlib import Path
    torch.set_num_threads(1)
    from blt_tpu_torch.config import ContentType, CoreConfig
    from blt_tpu_torch.parallel import distributed
    from blt_tpu_torch.pipeline.engines import ShardedTorchEngine, TorchEngine
    from blt_tpu_torch.pipeline.runner import run_tokenizer

    cpu = torch.device("cpu")
    engines = {"numpy": lambda: "numpy", "torch": lambda: TorchEngine(cpu),
               "shard": lambda: ShardedTorchEngine([cpu] * 2)}
    for job in json.load(open(sys.argv[1])):
        config = CoreConfig.new_from_cli(
            input=Path(job["input"]), output=Path(job["output"]),
            content_type=ContentType.TEXT,
            chunksize=job["chunksize"], passthrough=job["mode"] == "passthrough",
            decode=job["mode"] == "decode",
            merges=job["merges"] if isinstance(job["merges"], str) else None)
        if isinstance(job["merges"], list):
            config.with_merges({(a, b): v for a, b, v in job["merges"]})
        run_tokenizer(config, engine=engines[job["engine"]]())
    if distributed.process_count() != 2:
        sys.exit("the multi-process branch was not taken")
    """
)

MODES = ["basic", "flat", "hierarchical", "passthrough", "decode"]
ENGINES = ["numpy", "torch", "shard"]


def _jobs(tmp):
    """The jobs, and for each its single-process port and JAX outputs."""
    data = _data(9, 700_003)
    src = tmp / "in.bin"
    src.write_bytes(data.tobytes())
    # each process gets bytes in every mode: the 256 KB chunk grid splits too
    hcfg = CoreConfig.new_from_cli(chunksize="256KB")
    hcfg.with_merges(HIER)
    assert 0 < multihost.plan_bounds(hcfg, data.shape[0], data, 2)[1] < data.shape[0]
    mp = _merges_file(tmp / "m.txt")
    wire = tmp / "wire.bin"
    jax_run_tokenizer(JaxConfig.new_from_cli(input=src, output=wire, merges=mp,
                                             content_type=JaxContentType.TEXT,
                                             engine=JaxEngineName.NUMPY))
    hier = [[a, b, v] for (a, b), v in HIER.items()]
    spec = {"basic": (src, None, None), "flat": (src, str(mp), None),
            "hierarchical": (src, hier, "256KB"), "passthrough": (src, None, None),
            "decode": (wire, str(mp), None)}
    jobs, refs = [], {}
    for mode, (inp, merges, chunk) in spec.items():
        port_ref, jax_ref = tmp / f"{mode}.port", tmp / f"{mode}.jax"
        kw = dict(input=inp, content_type=ContentType.TEXT, chunksize=chunk,
                  passthrough=mode == "passthrough", decode=mode == "decode",
                  merges=merges if isinstance(merges, str) else None)
        cfg = CoreConfig.new_from_cli(output=port_ref, **kw)
        jkw = {**kw, "content_type": JaxContentType.TEXT}
        jcfg = JaxConfig.new_from_cli(output=jax_ref, engine=JaxEngineName.NUMPY, **jkw)
        if isinstance(merges, list):
            cfg.with_merges(HIER)
            jcfg.with_merges(HIER)
        run_tokenizer(cfg, engine="numpy")
        jax_run_tokenizer(jcfg)
        refs[mode] = (port_ref.read_bytes(), jax_ref.read_bytes())
        for engine in ENGINES:
            jobs.append({"mode": mode, "engine": engine, "input": str(inp),
                         "output": str(tmp / f"{mode}.{engine}.dist"),
                         "merges": merges, "chunksize": chunk})
    return jobs, refs, data.tobytes()


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_processes")
    jobs, refs, data = _jobs(tmp)
    spec = tmp / "jobs.json"
    spec.write_text(json.dumps(jobs))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(BLT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", BLT_NUM_PROCESSES="2",
               BLT_DEVICE_BATCH_BYTES=str(128 * 1024))
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(spec)],
                         env={**env, "BLT_PROCESS_ID": str(pid)},
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)
    ]
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            if p.returncode != 0:
                errors.append(err.decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {(j["mode"], j["engine"]): open(j["output"], "rb").read()
            for j in jobs if not errors}, refs, data, errors


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_two_processes_match_single_process_and_jax(two_processes, mode, engine):
    outs, refs, data, errors = two_processes
    assert not errors, errors
    port_ref, jax_ref = refs[mode]
    assert port_ref == jax_ref
    assert outs[(mode, engine)] == port_ref
    if mode == "decode":
        assert outs[(mode, engine)] == data
