"""The eight glue-only timing tools of the torch port against the JAX package, on the CPU.

``blt_tpu_torch.tools.{exp_multipass, exp_mp, exp_gap, exp_gapvar,
exp_compact, exp_e2e, exp_dense, exp_occ}`` time the multipass loop, the
engine and the 50k table. On the CPU the port's wrappers run their plain
PyTorch versions, held here against the JAX package's own functions with
``interpret=True`` (``PallasTokenEncoder``, ``_multipass_gap_wire_call``,
``_multipass_resident_call``, ``_multipass_gap_resident_call``,
``_token_pass_call``), ``bpe_jax.multipass_encode``, the JAX runner's NumPy
engine and ``blt_tpu.ops.bpe_numpy``, or the JAX tools' own expressions.
The JAX tools are loaded by path (``tools/*.py``, not a package); their
tables and recipes, which sit inside their ``main``, are read from the
source as literals, so the port's copies are held to them. Every
comparison is exact (tolerance 0: every value is an integer token). Inputs
come from numpy ``default_rng(seed)``, at 16-64 KiB (1 MiB where a tool's
row is a 1 MiB prefix) and capacities of a few 4096-token tiles. The CUDA
paths themselves are held against the plain versions by
tests/test_torch_gpu.py and ``chip_smoke.py``.

Then each tool's entry point runs as a process on the CPU, and without a
card by default exits naming CUDA.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_tpu.config import CoreConfig as JaxCoreConfig
from blt_tpu.config import Engine as JaxEngine
from blt_tpu.merges import MergeTable as JaxMergeTable
from blt_tpu.ops import bpe_jax
from blt_tpu.ops import bpe_numpy as jax_bpe_numpy
from blt_tpu.ops import bpe_pallas as bp
from blt_tpu.pipeline.runner import run_tokenizer as jax_run_tokenizer
from blt_tpu.utils import compcache
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_cuda, bpe_torch, multipass_cuda
from blt_tpu_torch.ops.multipass_cuda import CudaTokenEncoder
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.pipeline.engines import TorchEngine
from blt_tpu_torch.tools import (
    _common,
    exp_compact,
    exp_dense,
    exp_e2e,
    exp_gap,
    exp_gapvar,
    exp_mp,
    exp_multipass,
    exp_occ,
)
from blt_tpu_torch.tools.exp_mp_ablate import HIER

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RPB = 8  # Pallas rows per block: 1024-token blocks
TOOLS = ("exp_multipass", "exp_mp", "exp_gap", "exp_gapvar", "exp_compact", "exp_e2e",
         "exp_dense", "exp_occ")


def _load(name, path):
    """A module loaded by path; the fixed checkout path the JAX tools put on
    ``sys.path`` is taken back out, and the compile cache a tool enables
    at load is left as it was."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    saved, enabled = sys.path[:], compcache._enabled
    compcache._enabled = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
        compcache._enabled = enabled
    return mod


def _jax_tool(name):
    return _load(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")


def _literal(tool: str, name: str):
    """The value of the literal assigned to ``name`` anywhere in the JAX
    tool's source (its tables and recipes sit inside its ``main``)."""
    tree = ast.parse((REPO / "tools" / f"{tool}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(f"{tool}.py assigns no literal {name}")


def _corpus(seed, n):
    return _common.make_corpus(np.random.default_rng(seed), n)


def _jax_planes(merges):
    k1, v1, k2, v2, a1, a2 = JaxMergeTable.build(merges).build_cuckoo32()
    shift = 32 - (k1.shape[0].bit_length() - 1)
    return [jnp.asarray(x.reshape(-1, 128)) for x in (k1, v1, k2, v2)], (a1, a2, shift)


def _hp(merges):
    planes, (a1, a2, shift) = _jax_planes(merges)
    return planes, jnp.asarray([a1, a2, shift], jnp.int32)


def _jax_capacity(n):
    block = RPB * 128
    return -(-max(n, 1) // block) * block


def _jax_gap_resident(data, merges, wire=False):
    """The JAX gap loop (or its wire), interpret mode: (out, m, capacity)."""
    n = data.shape[0]
    cap = _jax_capacity(n)
    buf = np.full(cap, -1, np.int32)
    buf[:n] = data
    planes, hp = _hp(merges)
    call = bp._multipass_gap_wire_call if wire else bp._multipass_gap_resident_call
    out, m = call(jnp.asarray(buf), jnp.int32(n), hp, *planes, capacity=cap, interpret=True,
                  rows_per_block=RPB)
    return np.asarray(out), int(m), cap


def _jax_sort_resident(data, merges):
    """The JAX sort loop, interpret mode: (compacted prefix, m)."""
    n = data.shape[0]
    cap = _jax_capacity(n)
    buf = np.zeros(bp._padded_rows(cap, RPB * 128, RPB) * 128, np.int32)
    buf[:n] = data
    planes, hp = _hp(merges)
    out, m = bp._multipass_resident_call(jnp.asarray(buf), jnp.int32(n), hp, *planes,
                                         capacity=cap, interpret=True, rows_per_block=RPB)
    return np.asarray(out)[: int(m)], int(m)


# --- (a) exp_multipass --------------------------------------------------------


def test_multipass_table_is_the_originals():
    assert exp_multipass.MERGES == _literal("exp_multipass", "merges")
    assert not MergeTable.build(exp_multipass.MERGES).flat


@pytest.mark.parametrize("n", [1, 2, 5000, 32 << 10, 64 << 10])
def test_multipass_encoders_equal_pallas_and_bpe_jax(n):
    data = _corpus(1, n)
    table = MergeTable.build(exp_multipass.MERGES)
    jax_table = JaxMergeTable.build(exp_multipass.MERGES)
    port = CudaTokenEncoder(table, CPU, capacity_tokens=n)
    jax_enc = bp.PallasTokenEncoder(jax_table, interpret=True, capacity_tokens=n,
                                    rows_per_block=RPB)
    want = jax_enc.encode(data)
    assert port.encode(data).tolist() == want.tolist()
    # the twin route against bpe_jax.multipass_encode, on the tool's padding
    buf = np.zeros(max(bpe_cuda._round_capacity(n), 128), np.uint8)
    buf[:n] = data
    toks, count = bpe_torch.multipass_encode(torch.from_numpy(buf), n,
                                             *bpe_torch.sparse_table_device(table))
    jtoks, jcount = bpe_jax.multipass_encode(jnp.asarray(buf), jnp.int32(n),
                                             *bpe_jax.sparse_table_device(jax_table))
    assert int(count) == int(jcount) == want.size
    assert toks[: int(count)].tolist() == np.asarray(jtoks)[: int(jcount)].tolist()


# --- (b) exp_mp -----------------------------------------------------------------


def test_mp_table_and_alphabet_are_the_originals():
    assert exp_mp.MERGES == _literal("exp_mp", "merges")
    src = (REPO / "tools" / "exp_mp.py").read_text()
    assert f'np.frombuffer(b"{exp_mp.ALPHABET.decode()}", np.uint8)' in src
    assert "default_rng(3)" in src and exp_mp.SEED == 3


@pytest.mark.parametrize("n", [1000, 16 << 10, 48 << 10])
def test_mp_sort_loop_equals_device_multipass(n):
    jax_mp = _jax_tool("exp_mp")
    data = exp_mp.alphabet_data(np.random.default_rng(3), n)
    jax_enc = bp.PallasTokenEncoder(JaxMergeTable.build(exp_mp.MERGES), interpret=True,
                                    capacity_tokens=n, rows_per_block=RPB)
    run, total = jax_mp.device_multipass(jax_enc, jax_enc.capacity)
    buf = np.zeros(total, np.int32)
    buf[:n] = data
    out, m = run(jnp.asarray(buf), jnp.int32(n))
    enc = CudaTokenEncoder(MergeTable.build(exp_mp.MERGES), CPU, capacity_tokens=n)
    multipass_cuda.reset_launches()
    toks, count = exp_mp.sort_loop(enc, data)
    assert int(count) == int(m)
    assert toks[: int(count)].tolist() == np.asarray(out)[: int(m)].tolist()
    assert multipass_cuda.loop_log[-1][0] >= 3  # the chains take more rounds than a flat table


# --- (c) exp_gap's loops ------------------------------------------------------------


def test_gap_loop_table_is_the_originals():
    assert HIER == _literal("exp_gap", "hier")
    assert exp_gap.LOOP_BYTES == _jax_tool("exp_gap").NBYTES
    assert (exp_gap.LOOP_REPS, exp_gap.PIPE) == (5, 6)


@pytest.mark.parametrize("n", [4096, 20000, 48 << 10])
def test_gap_wire_and_sort_loops_equal_pallas(n):
    data = _corpus(2, n)
    wire, m, cap = _jax_gap_resident(data, HIER, wire=True)
    want = bp.expand_gap_wire_host(wire, cap)
    assert want.shape[0] == m
    enc = CudaTokenEncoder(MergeTable.build(HIER), CPU, capacity_tokens=n)
    x = torch.from_numpy(data.astype(np.int32))
    pwire, pm, pcap = exp_gap.gap_wire_dispatch(enc, x)
    got = exp_gap.expand_gap_wire_host(pwire.numpy(), pcap)
    assert int(pm) == m and got.tobytes() == want.tobytes()
    sort_want, sort_m = _jax_sort_resident(data, HIER)
    toks, count = exp_mp.sort_loop(enc, x)
    assert int(count) == sort_m and toks[: int(count)].tolist() == sort_want.tolist()


def test_gap_loop_rows_hold_every_loop_to_the_oracle():
    rows, expand = exp_gap.loop_rows(_corpus(3, 24 << 10), CPU)
    assert [(r["name"], r["rpb"]) for r in rows] == [
        ("gap_wire_loop", 512), ("gap_wire_loop", 1024), ("sort_loop", 512)]
    for r in rows:
        assert r["exact"] is True and r["wall"]["reps"] == 5 and r["wall"]["pipe"] == 6
        assert r["wall"]["MB_per_s"]["n"] == 5 and r["bound_ms"] > 0
    assert expand["n"] == 3 and expand["mean"] > 0


# --- (d) exp_gapvar --------------------------------------------------------------


def test_gapvar_table_and_rounds_are_the_originals():
    assert HIER == _literal("exp_gapvar", "hier")
    jax_gapvar = _jax_tool("exp_gapvar")
    assert (exp_gapvar.ROUNDS, exp_gapvar.SIZE_MIB * _common.MIB) == (jax_gapvar.ROUNDS,
                                                                      jax_gapvar.NBYTES)


def _gapvar_data(n):
    rng = np.random.default_rng(4)
    return rng.choice(np.frombuffer(b"abcabcabc ab", np.uint8), size=n).astype(np.uint8)


@pytest.mark.parametrize("variant", exp_gapvar.VARIANTS)
def test_gapvar_variant_equals_gap_resident_pallas(variant):
    n = 40000
    data = _gapvar_data(n)
    out, m, _ = _jax_gap_resident(data, HIER)
    enc = CudaTokenEncoder(MergeTable.build(HIER), CPU, capacity_tokens=n)
    toks, count = exp_gapvar.run(enc, torch.from_numpy(data.astype(np.int32)), variant)
    toks = toks.numpy()
    assert int(count) == m
    assert toks[toks >= 0].tolist() == out[out >= 0].tolist()


def test_gapvar_input_takes_a_compaction():
    """The variants' input runs past a compaction, so the glue that differs
    runs on a compacted buffer too."""
    enc = CudaTokenEncoder(MergeTable.build(HIER), CPU, capacity_tokens=40000)
    multipass_cuda.reset_launches()
    enc._gap_loop(torch.from_numpy(_gapvar_data(40000).astype(np.int32)))
    rounds, compactions = multipass_cuda.loop_log[-1]
    assert rounds > multipass_cuda.GAP_COMPACT_EVERY and compactions >= 1
    with pytest.raises(ValueError, match="unknown glue"):
        exp_gapvar.loop_variant(enc, _gapvar_data(100), "E")


# --- (e) exp_compact -------------------------------------------------------------


CAP = 16 << 10


@pytest.fixture(scope="module")
def pass1():
    """Pass 1's output over CAP tokens with the tool's table, from the port
    (plain K4) and from ``_token_pass_call`` in interpret mode."""
    host = _corpus(5, CAP)
    planes, (a1, a2, shift) = _jax_planes(HIER)
    buf = np.zeros(CAP + 8 * 128, np.int32)  # + the 8 halo rows
    buf[:CAP] = host
    params = jnp.asarray(np.array([CAP, a1, a2, shift, 0, 0, 0, 0], np.int32))
    out = bp._token_pass_call(params, jnp.asarray(buf.reshape(-1, 128)), *planes,
                              interpret=True, rows_per_block=RPB)
    jax_out = np.asarray(out).reshape(-1)[:CAP]
    enc = CudaTokenEncoder(MergeTable.build(HIER), CPU, capacity_tokens=CAP)
    port = multipass_cuda.token_pass(torch.from_numpy(host.astype(np.int32)), CAP, enc.planes)
    return host, jax_out, port.numpy(), enc


def test_compact_table_and_sizes_are_the_originals():
    assert HIER == _literal("exp_compact", "hier")
    jax_compact = _jax_tool("exp_compact")
    assert exp_compact.SIZE_MIB * _common.MIB == jax_compact.CAP
    assert exp_compact.K == jax_compact.INNER and _common.REPS == jax_compact.REPS


def _jax_row(name, vals_h, alive_h, idx_h, pos_h):
    """The JAX tool's expression for a row (tools/exp_compact.py:116-160),
    run on the CPU."""
    cap = vals_h.shape[0]
    vals, alive = jnp.asarray(vals_h), jnp.asarray(alive_h)
    iota = jnp.arange(cap, dtype=jnp.int32)
    if name == "sortkv":
        keys = jnp.where(alive, iota, cap + iota)
        return jax.lax.sort_key_val(keys, vals)[1]
    if name == "sort1bit":
        key = (~alive).astype(jnp.int32)
        return jax.lax.sort((key, vals), is_stable=True, num_keys=1)[1]
    if name == "cumsum":
        return jnp.cumsum(alive.astype(jnp.int32))
    if name == "take":
        return vals[jnp.asarray(idx_h)]
    if name == "scatter":
        return jnp.zeros(cap, jnp.int32).at[jnp.asarray(pos_h)].set(
            vals, mode="drop", unique_indices=True, indices_are_sorted=False)
    raise KeyError(name)


@pytest.mark.parametrize("row", exp_compact.ROWS)
def test_compact_row_equals_the_jax_expression(pass1, row):
    host, jax_out, port_out, enc = pass1
    assert np.array_equal(port_out, jax_out)  # pass 1, both sides
    alive_h = jax_out != -1
    assert 0 < alive_h.sum() < CAP
    # the tool's host inputs of take and scatter
    idx_h = np.minimum(np.arange(CAP, dtype=np.int32) + np.cumsum(~alive_h).astype(np.int32),
                       CAP - 1)
    pos_h = np.where(alive_h, np.cumsum(alive_h).astype(np.int32) - 1, CAP).astype(np.int32)
    got_alive, got_idx, got_pos = exp_compact.host_inputs(port_out)
    assert np.array_equal(got_alive, alive_h) and np.array_equal(got_idx, idx_h)
    assert np.array_equal(got_pos, pos_h)
    vals = torch.from_numpy(port_out)
    alive = torch.from_numpy(alive_h)
    if row == "pass":
        assert np.array_equal(port_out, _common.pass_host(host, MergeTable.build(HIER)))
        return
    if row == "fullloop":
        want, m = _jax_sort_resident(host, HIER)
        toks, count = enc._sort_loop(torch.from_numpy(host.astype(np.int32)))
        assert int(count) == m and toks[:m].tolist() == want.tolist()
        return
    partition = np.concatenate([jax_out[alive_h], jax_out[~alive_h]])
    if row == "compact":
        out, count = bpe_torch._compact(vals, alive)
        zero_tail = np.asarray(_jax_row("sortkv", jax_out, alive_h, idx_h, pos_h)).copy()
        zero_tail[int(alive_h.sum()):] = 0
        assert int(count) == int(alive_h.sum())
        assert np.array_equal(out.numpy(), zero_tail)
        assert np.array_equal(out.numpy()[: int(count)], partition[: int(count)])
        return
    fn = {"sortkv": lambda: exp_compact.sortkv(vals, alive),
          "sort1bit": lambda: exp_compact.sort1bit(vals, alive),
          "cumsum": lambda: exp_compact.cumsum(alive),
          "take": lambda: exp_compact.take(vals, torch.from_numpy(idx_h)),
          "scatter": lambda: exp_compact.scatter(vals, torch.from_numpy(pos_h))}[row]
    want = np.asarray(_jax_row(row, jax_out, alive_h, idx_h, pos_h))
    assert np.array_equal(fn().numpy(), want)
    if row in ("sortkv", "sort1bit"):
        assert np.array_equal(want, partition)


def test_compact_measure_holds_every_row():
    result = exp_compact.measure(CPU, 32 << 10, k=1)
    assert [r["name"] for r in result["rows"]] == list(exp_compact.ROWS)
    assert result["exact"] is True and result["tombstones"] > 0
    assert result["rows"][-1]["mb_per_s"] > 0


# --- (f) exp_e2e -------------------------------------------------------------------


def test_e2e_recipe_is_the_originals(tmp_path):
    bench = _load("jax_benches_pipeline_benchmark", REPO / "benches" / "pipeline_benchmark.py")
    n = (4 << 20) + 12345  # past one base
    bench.make_file(str(tmp_path / "jax.bin"), n)
    exp_e2e.make_file(str(tmp_path / "port.bin"), n)
    assert (tmp_path / "jax.bin").read_bytes() == (tmp_path / "port.bin").read_bytes()
    src = (REPO / "tools" / "exp_e2e.py").read_text()
    assert "for a, b in [(101, 116), (116, 97), (97, 111), (32, 101)]:" in src
    assert exp_e2e.MERGES == ((101, 116), (116, 97), (97, 111), (32, 101))
    assert '"--batches-mb", default="64,16,8"' in src and exp_e2e.BATCHES_MB == (64, 16, 8)


@pytest.mark.parametrize("mode", ["basic", "bpe"])
def test_e2e_runs_equal_the_jax_numpy_engine(tmp_path, monkeypatch, mode):
    ip, mp = str(tmp_path / "in.bin"), str(tmp_path / "m.txt")
    exp_e2e.make_file(ip, 1 << 20)
    with open(mp, "w") as f:
        f.writelines(f"{a} {b}\n" for a, b in exp_e2e.MERGES)
    ref = str(tmp_path / "ref.bin")
    jax_run_tokenizer(JaxCoreConfig.new_from_cli(
        input=ip, output=ref, merges=mp if mode == "bpe" else None, engine=JaxEngine.NUMPY))
    want = Path(ref).read_bytes()
    for batch in (256 << 10, 64 << 10):
        monkeypatch.setenv("BLT_DEVICE_BATCH_BYTES", str(batch))
        out = str(tmp_path / f"out_{batch}.bin")
        exp_e2e.run_once(ip, out, mode, TorchEngine(CPU), mp)
        assert Path(out).read_bytes() == want


def test_e2e_measure_restores_the_batch_size(monkeypatch):
    monkeypatch.delenv("BLT_DEVICE_BATCH_BYTES", raising=False)
    result = exp_e2e.measure(CPU, 1 << 20, k=1, batches_mb=(1,))
    assert result["exact"] is True and "BLT_DEVICE_BATCH_BYTES" not in os.environ
    assert result["small_link"]["exact"] and result["small_run"]["bytes"] == 1 << 20
    (row,) = result["rows"]
    assert row["batch_bytes"] == 1 << 20 and set(row["stage_stats"]) >= {"feed", "drain"}
    with pytest.raises(ValueError, match="unknown mode"):
        exp_e2e.measure(CPU, 1 << 20, mode="decode")


# --- (g) exp_dense and exp_occ -------------------------------------------------------


def test_dense_table_is_the_originals():
    jax_dense = _jax_tool("exp_dense")
    assert (exp_dense.RULES, exp_dense.K, exp_dense.SIZE_MIB * _common.MIB) == (
        jax_dense.RULES, jax_dense.K, jax_dense.N)
    src = (REPO / "tools" / "exp_dense.py").read_text()
    assert "rng = np.random.default_rng(1)" in src and exp_dense.TABLE_SEED == 1
    # the original's lines, on the same generator
    rng = np.random.default_rng(1)
    all_pairs = rng.permutation(65536)[:jax_dense.RULES]
    merges = {(int(p) // 256, int(p) % 256): 256 + i for i, p in enumerate(all_pairs)}
    assert exp_dense.dense_merges(np.random.default_rng(1)) == merges


def test_occ_tables_are_the_originals():
    jax_occ = _jax_tool("exp_occ")
    assert (exp_occ.K, exp_occ.RPB, exp_occ.SIZE_MIB * _common.MIB) == (
        jax_occ.K, jax_occ.RPB, jax_occ.N)
    rng_port, rng_jax = np.random.default_rng(1), np.random.default_rng(1)
    for rules, first_bytes in exp_occ.POINTS:
        port = exp_occ.make_table(rng_port, rules, first_bytes)
        jax_table = jax_occ.make_table(rng_jax, rules, first_bytes)
        assert port.merges == jax_table.merges
        assert exp_occ.occupied_first_bytes(port) == len({a for a, _ in jax_table.merges})


def _k2_prefix_tokens(host, table):
    """K2 fused with its pack (plain, on the CPU) over ``host`` alone,
    expanded on the host: int tokens."""
    m = host.shape[0]
    wire, _, _ = bpe_cuda.flat_encode_packed(
        torch.from_numpy(host), m, -1, wire_table(table.dense, CPU),
        torch.zeros((1, 1), dtype=torch.int32), torch.zeros((), dtype=torch.int32))
    wire = wire.numpy()
    return np.frombuffer(bpe_cuda.unpack_slots_host(wire[:m], wire[m:], m).tobytes(),
                         ">u2").astype(np.int64)


@pytest.mark.parametrize("which", ["dense", "occ_9000"])
def test_k2_rows_on_a_1_mib_prefix_equal_bpe_numpy(which):
    host = _corpus(1, 1 << 20)
    if which == "dense":
        merges = exp_dense.dense_merges(np.random.default_rng(1))
    else:
        merges = exp_occ.make_table(np.random.default_rng(6), 9000, 48).merges
    got = _k2_prefix_tokens(host, MergeTable.build(merges))
    want = jax_bpe_numpy.bpe_encode_flat(host, JaxMergeTable.build(merges))
    assert got.tolist() == want.tolist()
    assert exp_dense.prefix_exact(host, MergeTable.build(merges),
                                  wire_table(MergeTable.build(merges).dense, CPU))


# --- (h) the entry points, as processes ---------------------------------------------


def _run(tool, *args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", f"blt_tpu_torch.tools.{tool}", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


@pytest.mark.parametrize("tool", TOOLS)
def test_entry_point_runs_on_the_cpu(tool):
    r = _run(tool, "--device", "cpu", "--size-mib", "1", "--k", "1")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["tool"] == tool and out["exact"] is True
    assert out["device"] == {"type": "cpu"} and out["size_bytes"] == 1 << 20
    for row in out["rows"]:
        assert row["exact"] is True and row["bound_ms"] > 0
        assert ("wall" in row) != ("eager" in row)


@pytest.mark.parametrize("tool", TOOLS)
def test_entry_point_needs_the_card_by_default(tool):
    r = _run(tool, "--size-mib", "1", timeout=120)
    assert r.returncode != 0 and "CUDA" in r.stderr and not r.stdout.strip()
