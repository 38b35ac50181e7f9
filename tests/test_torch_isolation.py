"""The torch port stands alone: it imports nothing of ``blt_tpu`` or ``jax``,
and its copies of the JAX package's host modules behave as the originals.

- An AST scan of every module of the port (its device-rate tools under
  ``blt_tpu_torch/tools/`` included) and of ``chip_smoke.py``: no import of
  ``blt_tpu``, ``jax`` or the JAX tools' ``tools`` directory.
- A fresh interpreter runs the port's CLI, API and ``TorchEngine`` on the
  CPU in every mode (basic, flat BPE, general-table multipass in both
  compaction policies and the twin route, passthrough, decode) and its
  first six device-rate tools, and then finds no ``blt_tpu``,
  ``blt_tpu.*``, ``tools``, ``tools.*`` or ``jax*`` in ``sys.modules``;
  a second one does the same with the next four tools (``exp_gather``'s
  T13 rows), at 1 MiB and one launch each, and a third with ``exp_16bit``,
  ``canary_16bit`` and ``exp_gather``'s T14 and library rows.
- Parity of the copied host modules with the JAX package's: merges parsing
  and its errors, ``MergeTable`` fields and the cuckoo32 planes and
  constants, chunk planning and size parsing, and decode.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from blt_tpu import merges as jax_merges
from blt_tpu.ops import decode as jax_decode
from blt_tpu.utils import chunking as jax_chunking
from blt_tpu.utils import parsing as jax_parsing
from blt_tpu_torch import merges as port_merges
from blt_tpu_torch.ops import decode as port_decode
from blt_tpu_torch.utils import chunking as port_chunking
from blt_tpu_torch.utils import parsing as port_parsing

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "blt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("blt_tpu", "jax", "jaxlib", "tools")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            if _forbidden(node.module):
                found.append(node.module)
    assert not found, f"{path.name} imports {found}"


def test_every_mode_runs_without_the_jax_package(tmp_path):
    src = tmp_path / "in.txt"
    src.write_bytes(b"ab c abcab xyz " * 4000)
    merges = tmp_path / "m.txt"
    merges.write_text("97 98\n32 99\n")
    # one intra-op thread: the run shares the cores with the suite's other
    # workers, where a pool of spinning threads per process stalls them all
    code = f"""
import os, sys, torch
torch.set_num_threads(1)
import blt_tpu_torch
from blt_tpu_torch import cli
from blt_tpu_torch.config import CoreConfig
from blt_tpu_torch.pipeline.engines import TorchEngine
from blt_tpu_torch.pipeline.runner import run_tokenizer
src, out, m = {str(src)!r}, {str(tmp_path / "o.bin")!r}, {str(merges)!r}
cpu = TorchEngine(torch.device("cpu"))
general = {{(97, 98): 256, (256, 99): 257, (32, 256): 258}}
for merges in (None, m):
    for passthrough in (False, True):
        config = CoreConfig.new_from_cli(input=src, output=out, merges=merges, passthrough=passthrough)
        run_tokenizer(config, engine=cpu)
for env in ({{}}, {{"BLT_MP_COMPACT": "sort"}}, {{"BLT_MULTIPASS": "xla"}}):
    os.environ.update(env)
    config = CoreConfig.new_from_cli(input=src, output=out, chunksize="256KB")
    run_tokenizer(config.with_merges(general), engine=cpu)
    for k in env:
        del os.environ[k]
assert cli.main(["-i", src, "-o", out, "--engine", "numpy", "--merges", m, "--type", "text"]) == 0
assert cli.main(["-i", out, "-o", out + ".d", "--decode", "--merges", m, "--type", "text"]) == 0
assert open(out + ".d", "rb").read() == open(src, "rb").read()
tok = blt_tpu_torch.ByteTokenizer(merges=general, engine="numpy")
tok.tokenize_file(src, out)
assert tok.detokenize_bytes(tok.tokenize_bytes(b"abcab").astype(">u2").tobytes()) == b"abcab"
from blt_tpu_torch.tools import exp_chain, exp_mp_ablate, exp_pack, exp_parts, exp_scan, exp_sweep
for tool in (exp_chain, exp_sweep, exp_parts, exp_pack, exp_mp_ablate, exp_scan):
    assert tool.measure(torch.device("cpu"), 1 << 20, k=1)["exact"]
bad = sorted(k for k in sys.modules
             if k in ("blt_tpu", "tools") or k.startswith(("blt_tpu.", "tools.", "jax")))
assert not bad, bad
print("isolated")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, env=env,
                       timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert r.stdout.decode().strip() == "isolated"


def test_the_later_tools_run_without_the_jax_package():
    code = """
import sys, torch
torch.set_num_threads(1)
from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import exp_bf16scan, exp_chd, exp_gather, exp_opt
for tool in (exp_opt, exp_chd, exp_bf16scan):
    assert tool.measure(torch.device("cpu"), 1 << 20, k=1)["exact"]
assert exp_gather.measure(torch.device("cpu"), 1 << 20, k=1, only=tools_cuda.LOOKUPS)["exact"]
bad = sorted(k for k in sys.modules
             if k in ("blt_tpu", "tools") or k.startswith(("blt_tpu.", "tools.", "jax")))
assert not bad, bad
print("isolated")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, env=env,
                       timeout=240, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert r.stdout.decode().strip() == "isolated"


def test_the_tensor_core_and_16_bit_tools_run_without_the_jax_package():
    code = """
import sys, torch
torch.set_num_threads(1)
from blt_tpu_torch.tools import canary_16bit, exp_16bit, exp_gather
cpu = torch.device("cpu")
assert exp_16bit.measure(cpu, 1 << 20, k=1)["exact"]
assert canary_16bit.measure(cpu, k=1)["exact"]
rows = exp_gather.VARIANTS[5:]  # T14's two and the three library rows
assert exp_gather.measure(cpu, 64 * 512, k=1, only=rows)["exact"]
bad = sorted(k for k in sys.modules
             if k in ("blt_tpu", "tools") or k.startswith(("blt_tpu.", "tools.", "jax")))
assert not bad, bad
print("isolated")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, env=env,
                       timeout=240, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert r.stdout.decode().strip() == "isolated"


# --- parity of the copied host modules --------------------------------------

MERGES_TEXTS = [
    "97 98\n98 99\n",
    "# comment\n\n97 98\n97 98\n",  # duplicate pair: last line wins, ids advance
    "+1 2\n255 0\n",
    "97\n",
    "1 2 3\n",
    "256 1\n",
    "1 x\n",
    " \n",
    "",
]


@pytest.mark.parametrize("text", MERGES_TEXTS)
def test_merges_parsing_and_errors_equal(text):
    def parse(mod):
        try:
            return "ok", mod.parse_merges_text(text)
        except mod.MergesFormatError as e:
            return "error", str(e)

    assert parse(port_merges) == parse(jax_merges)
    assert issubclass(port_merges.MergesFormatError, ValueError)
    assert port_merges.NO_RULE == jax_merges.NO_RULE


def _random_general(seed, n, top):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(top * top)[:n]
    return {(int(k) // top, int(k) % top): int(v)
            for k, v in zip(keys, rng.integers(0, 65536, n))}


TABLES = [
    {},
    {(97, 98): 256, (98, 99): 257},
    {(97, 98): 256, (256, 99): 257, (120, 121): 90},
    {(0xFFFF, 0xFFFF): 0xFFFF, (40000, 97): 32768},
    _random_general(1, 3000, 2000),
    _random_general(2, 8000, 600),
    _random_general(3, 9000, 600),  # more rules than slots: no placement
]


@pytest.mark.parametrize("merges", TABLES, ids=lambda m: f"{len(m)}rules")
def test_merge_table_and_cuckoo32_equal(merges):
    p = port_merges.MergeTable.build(merges)
    j = jax_merges.MergeTable.build(merges)
    assert p.flat == j.flat and len(p) == len(j) and p.merges == j.merges
    assert np.array_equal(p.dense, j.dense)
    assert np.array_equal(p.sparse_keys, j.sparse_keys)
    assert np.array_equal(p.sparse_vals, j.sparse_vals)
    assert p.cuckoo_slots() == j.cuckoo_slots()
    pc, jc = p.build_cuckoo32(), j.build_cuckoo32()
    assert (pc is None) == (jc is None)
    if pc is not None:
        for a, b in zip(pc[:4], jc[:4]):
            assert np.array_equal(a, b)
        assert pc[4:] == jc[4:]
        assert p.build_cuckoo32() is pc  # memoized


def test_merge_table_range_check_equal():
    for mod in (port_merges, jax_merges):
        with pytest.raises(ValueError, match="u16"):
            mod.MergeTable.build({(1, 70000): 300})


@pytest.mark.parametrize("cli_size", [None, 1, 300 * 1024, 16 << 20, 1 << 30])
@pytest.mark.parametrize("threads,memcap", [(1, 80), (8, 10), (64, 100)])
def test_chunk_planning_equal(cli_size, threads, memcap):
    assert port_chunking.get_effective_chunk_size(cli_size, threads, memcap) == \
        jax_chunking.get_effective_chunk_size(cli_size, threads, memcap)
    assert port_chunking.mem_budget_bytes(memcap) == jax_chunking.mem_budget_bytes(memcap)
    for n in (0, 1, 1023, 1024, 12345):
        assert port_chunking.align_up(n) == jax_chunking.align_up(n)


@pytest.mark.parametrize("text", ["1024", "16KB", "2mb", " 7 ", "10.5MB", "1gb", "", "KB", "mb1"])
def test_size_parsing_equal(text):
    def parse(mod):
        try:
            return mod.parse_chunk_size_str(text)
        except mod.SizeParseError as e:
            return str(e)

    assert parse(port_parsing) == parse(jax_parsing)
    assert port_parsing.determine_thread_count(0) == jax_parsing.determine_thread_count(0)


DECODE_CASES = [
    ({}, b"\x00a\x00b"),
    ({(97, 98): 256, (256, 99): 257}, b"\x01\x01\x00a"),
    ({(97, 98): 256}, b"\x01\x02"),  # no such rule
    ({(97, 98): 90}, b"\x00a"),  # value collides with a byte: not invertible
    ({(97, 98): 300, (98, 99): 300}, b"\x00a"),  # one value, two pairs
    ({(300, 97): 301}, b"\x01\x2d"),  # a dead rule
]


@pytest.mark.parametrize("merges,wire", DECODE_CASES)
def test_decode_equal(merges, wire):
    def run(mod):
        try:
            table = mod.build_expansion_table(merges)
            return "ok", mod.decode_wire(np.frombuffer(wire, np.uint8), table).tobytes()
        except mod.DecodeError as e:
            return "error", str(e)

    assert run(port_decode) == run(jax_decode)
    big = np.frombuffer(b"\x01\x01\x00a" * 40000, np.uint8)  # the native path
    merges = {(97, 98): 256, (256, 99): 257}
    assert np.array_equal(
        port_decode.decode_wire(big, port_decode.build_expansion_table(merges)),
        jax_decode.decode_wire(big, jax_decode.build_expansion_table(merges)),
    )
