"""The device-rate path of the torch port against the JAX package, on the CPU.

K5 (``bpe_cuda.basic_encode_chained``), T1 (``tools.exp_chain`` copy and
widen chains), T7 (``tools.exp_sweep.copy_pallas``), T8 (the four
``tools.exp_parts`` variants) and ``bpe_cuda.flat_encode_chained``: on the
CPU the port's wrappers run their plain PyTorch versions, held here against
the JAX side run in interpret mode. K5 and K2's chain go through
``blt_tpu.ops.bpe_pallas``; T1, T7 and T8 through the JAX tools' own kernel
bodies, wrapped in ``pl.pallas_call(..., interpret=True)`` with the tools'
BlockSpecs (the tools' own calls take no ``interpret`` flag). Every
comparison is exact (tolerance 0): every value is an integer. Inputs come
from numpy ``default_rng(seed)``. The CUDA kernels themselves are held
against the plain versions by tests/test_torch_gpu.py and ``chip_smoke.py``.

Then the port's three entry points run as processes on the CPU.
"""

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
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from blt_tpu.merges import MergeTable as JaxMergeTable
from blt_tpu.ops import bpe_pallas
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import _common, exp_chain, exp_parts, exp_sweep

REPO = Path(__file__).resolve().parent.parent
LANES = 128
ROWS = 64  # 8 grid steps at 8 rows per block


def _jax_tool(name):
    """A JAX tool module of ``tools/``, loaded by path (not a package).
    The tools put a fixed checkout path at the head of ``sys.path`` when
    they load; it is taken back out, so later imports resolve from this
    checkout."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = sys.path[:]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


JAX_CHAIN = _jax_tool("exp_chain")
JAX_SWEEP = _jax_tool("exp_sweep")
JAX_PARTS = _jax_tool("exp_parts")


def test_loading_a_jax_tool_leaves_sys_path_as_it_was():
    before = sys.path[:]
    _jax_tool("exp_sweep")
    assert sys.path == before


def _bytes2(seed, rows=ROWS):
    return np.random.default_rng(seed).integers(0, 256, (rows, LANES)).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- K5 -----------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("rpb", [8, 16])
@pytest.mark.parametrize("tok", [0, 5])
def test_basic_chained_equals_pallas(k, rpb, tok):
    data = _bytes2(1)
    tok0 = np.full((1, 1), tok, np.int32)
    out, last = bpe_pallas.basic_encode_chained(
        jnp.asarray(data), jnp.asarray(tok0), k=k, interpret=True, rows_per_block=rpb)
    got_out, got_tok = bpe_cuda.basic_encode_chained(_t(data), _t(tok0), k, rpb)
    plain_out, plain_tok = bpe_cuda.basic_chained_plain(_t(data), _t(tok0), k, rpb)
    assert np.array_equal(got_out.numpy(), np.asarray(out))
    assert np.array_equal(got_tok.numpy(), np.asarray(last))
    assert torch.equal(got_out, plain_out) and torch.equal(got_tok, plain_tok)
    assert int(got_tok) == tok + k * (ROWS // rpb - 1)


def test_basic_chained_token_as_checked_in_interpret_mode():
    """tok 5, k 3, 8 grid steps: 5 + 3 * 7 = 26."""
    _, last = bpe_cuda.basic_encode_chained(_t(_bytes2(2)), torch.tensor([[5]], dtype=torch.int32), 3, 8)
    assert int(last) == 26


def test_chains_refuse_rows_the_grid_would_not_write():
    data = _t(_bytes2(3, rows=12))
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows_per_block"):
        bpe_cuda.basic_encode_chained(data, tok, 2, 8)
    with pytest.raises(ValueError, match="rows_per_block"):
        exp_chain.copy_chain(data, tok, 8, 2)
    with pytest.raises(ValueError, match="rows_per_block"):
        exp_sweep.copy_pallas(data, 8)
    with pytest.raises(ValueError, match="uint8"):
        bpe_cuda.basic_encode_chained(data.reshape(-1), tok, 1, 8)


def test_chains_refuse_unknown_names_and_untokened_chains():
    data = _t(_bytes2(3, rows=16))
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown chain"):
        bpe_cuda.chain_encode("chain_swap", data, tok, 1, 8)
    with pytest.raises(ValueError, match="no token input is one launch"):
        bpe_cuda.chain_encode("copy_sweep", data, None, 2, 8)
    with pytest.raises(ValueError, match="k >= 1"):
        bpe_cuda.chain_encode("chain_copy", data, tok, 0, 8)


# --- T1 and T7: the tools' own Pallas bodies in interpret mode ------------------


def _pallas_chain(kernel, data2, tok, rpb, out_dtype, k):
    """exp_chain._call's BlockSpecs, interpret mode, k calls chained."""
    rows = data2.shape[0]
    call = pl.pallas_call(
        kernel,
        grid=(rows // rpb,),
        in_specs=[
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=(
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((rows, LANES), out_dtype),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        interpret=True,
    )
    for _ in range(k):
        out, tok = call(tok, data2)
    return np.asarray(out), np.asarray(tok)


@pytest.mark.parametrize("op", ["copy", "widen"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("rpb", [8, 16])
def test_exp_chain_equals_tool_bodies(op, k, rpb):
    data = _bytes2(4)
    tok0 = np.full((1, 1), 7, np.int32)
    if op == "copy":
        body, dtype, port = JAX_CHAIN._copy_kernel, jnp.uint8, exp_chain.copy_chain
    else:
        body, dtype, port = JAX_CHAIN._widen_kernel, jnp.uint16, exp_chain.widen_chain
    ref_out, ref_tok = _pallas_chain(body, jnp.asarray(data), jnp.asarray(tok0), rpb, dtype, k)
    got_out, got_tok = port(_t(data), _t(tok0), rpb, k)
    assert np.array_equal(got_out.numpy(), ref_out)
    assert np.array_equal(got_tok.numpy(), ref_tok)
    plain = exp_chain.copy_chain_plain if op == "copy" else exp_chain.widen_chain_plain
    assert all(torch.equal(a, b) for a, b in zip(plain(_t(data), _t(tok0), rpb, k),
                                                (got_out, got_tok)))


@pytest.mark.parametrize("shape", [(4, LANES), (77,), (2,)])
def test_widen_call_equals_the_widen(shape):
    """The single PyTorch call of K1, K5 and T1 widen: ``00 b`` read as
    little-endian u16 is ``b << 8``, as the tool body writes it."""
    data = np.random.default_rng(8).integers(0, 256, shape).astype(np.uint8)
    data.reshape(-1)[:2] = [0, 255]
    got = exp_chain.widen_call(_t(data))
    assert got.dtype == torch.uint16 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), data.astype(np.uint16) << 8)


def test_exp_chain_rows_carry_their_single_call():
    out = exp_chain.measure(torch.device("cpu"), 1 << 20, k=2)
    library = {(r["name"], r["rpb"]): r["library_ms"] for r in out["rows"]}
    assert list(library) == [("copy", 2048), ("widen", 2048), ("widen", 8192),
                             ("basic_chained", 2048), ("bpe", None)]
    assert all(library[key] > 0 for key in list(library)[:4])
    assert library[("bpe", None)] is None and out["exact"] is True


@pytest.mark.parametrize("rpb", [8, 16, 64])
def test_exp_sweep_copy_equals_tool_body(rpb):
    data = _bytes2(5)
    rows = data.shape[0]
    out, done = pl.pallas_call(
        JAX_SWEEP._copy_kernel,
        grid=(rows // rpb,),
        in_specs=[pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=(
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((rows, LANES), jnp.uint8),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        interpret=True,
    )(jnp.asarray(data))
    got_out, got_done = exp_sweep.copy_pallas(_t(data), rpb)
    assert np.array_equal(got_out.numpy(), np.asarray(out))
    assert np.array_equal(got_done.numpy(), np.asarray(done))
    assert int(got_done) == rows // rpb - 1


def test_time_chain_holds_the_timed_result_to_the_expected_one():
    x = torch.arange(16)
    cpu = torch.device("cpu")
    good = _common.time_chain(lambda: (x.clone(),), 1, 16, cpu, (x,))
    bad = _common.time_chain(lambda: (x + 1,), 1, 16, cpu, (x,))
    assert good["exact"] is True and bad["exact"] is False
    assert good["eager"]["ms_per_launch"]["n"] == _common.REPS and good["graph"] is None
    with pytest.raises(RuntimeError, match="differs"):
        _common.chained_ms(lambda: (x + 1,), 2, 16, cpu, (x,))


def test_wrappers_count_no_launch_on_the_cpu():
    data = _t(_bytes2(6))
    tok = torch.zeros((1, 1), dtype=torch.int32)
    bpe_cuda.reset_launches()
    bpe_cuda.basic_encode_chained(data, tok, 3, 8)
    exp_chain.widen_chain(data, tok, 8, 3)
    exp_chain.copy_chain(data, tok, 8, 3)
    exp_sweep.copy_pallas(data, 8)
    table = torch.zeros(65536, dtype=torch.uint16)
    exp_parts.chain("full", data.reshape(-1), 100, -1, table, tok, 2)
    assert set(bpe_cuda.CHAINS) | {f"parts_{v}" for v in exp_parts.VARIANTS} <= set(
        bpe_cuda.launches)
    assert all(v == 0 for v in bpe_cuda.launches.values())


# --- T8: the exp_parts variants ------------------------------------------------

# no byte 255: the tool's inline cuckoo probe takes pair (255, 255) for a hit
# on any empty slot it probes (it lacks _kernel_body's e != -1 test), which
# the wire table does not
PARTS_ALPHABET = b"aabbcc hhpx\x00ab@"
PARTS_MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259,
                (32, 104): 260, (104, 104): 261, (112, 120): 262, (120, 0): 263,
                (0, 64): 264, (64, 97): 265}
PARTS_RPB = 8
PARTS_BLOCKS = 4  # 4 blocks of 8 rows


def _parts_pallas(variant, data, n, next_byte, carry, enc, k):
    """exp_parts.chain's grid spec in interpret mode, k calls chained."""
    rpb = PARTS_RPB
    total_rows = PARTS_BLOCKS * rpb
    buf = np.zeros(((total_rows + 8) * LANES,), np.uint8)
    buf[: data.shape[0]] = data
    data3 = jnp.asarray(buf.reshape(total_rows + 8, LANES))
    params = jnp.asarray(np.array([n, 0, next_byte, enc.a1, enc.a2, 0, enc.shift, 0], np.int32))
    call = pl.pallas_call(
        JAX_PARTS.make_variant_kernel(variant),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(PARTS_BLOCKS,),
            in_specs=[
                pl.BlockSpec((1, 1), lambda i, p: (0, 0), memory_space=pltpu.SMEM),
                pl.BlockSpec((rpb, LANES), lambda i, p: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((8, LANES), lambda i, p: ((i + 1) * rpb // 8, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
            ],
            out_specs=(
                pl.BlockSpec((rpb, LANES), lambda i, p: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1), lambda i, p: (0, 0), memory_space=pltpu.SMEM),
            ),
            scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        ),
        out_shape=(
            jax.ShapeDtypeStruct((total_rows, LANES), jnp.uint16),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        interpret=True,
    )
    c = jnp.asarray(np.full((1, 1), carry, np.int32))
    for _ in range(k):
        out, c = call(params, c, data3, data3, enc.e1, enc.e2)
    return np.asarray(out).reshape(-1), np.asarray(c)


@pytest.fixture(scope="module")
def parts_setup():
    enc = bpe_pallas.PallasFlatEncoder(
        JaxMergeTable.build(PARTS_MERGES), interpret=True, capacity_bytes=4096,
        rows_per_block=PARTS_RPB, force_mode="cuckoo")
    assert enc.mode == "cuckoo"
    table = wire_table(MergeTable.build(PARTS_MERGES).dense)
    rng = np.random.default_rng(8)
    data = rng.choice(np.frombuffer(PARTS_ALPHABET, np.uint8), PARTS_BLOCKS * PARTS_RPB * LANES)
    return enc, table, data.astype(np.uint8)


@pytest.mark.parametrize("variant", exp_parts.VARIANTS)
@pytest.mark.parametrize("carry", [0, 1])
@pytest.mark.parametrize("n,next_byte", [(4096, -1), (3001, 98), (3001, -1), (1, 98)])
def test_exp_parts_variants_equal_tool_body(parts_setup, variant, carry, n, next_byte):
    enc, table, data = parts_setup
    data = data.copy()
    data[n - 1] = 97  # (97, next_byte 98) is a rule
    ref_slots, ref_carry = _parts_pallas(variant, data, n, next_byte, carry, enc, 2)
    c = torch.tensor([[carry]], dtype=torch.int32)
    got_slots, got_carry = exp_parts.chain(variant, _t(data), n, next_byte, table, c, 2)
    assert np.array_equal(got_slots.numpy()[:n], ref_slots[:n])
    assert np.array_equal(got_carry.numpy(), ref_carry)


def test_exp_parts_full_is_k2_with_starts_swapped(parts_setup):
    """``full`` is K2's slot with each merge start's value byteswapped."""
    _, table, data = parts_setup
    c = torch.tensor([[1]], dtype=torch.int32)
    full, fc = exp_parts.flat_parts("full", _t(data), 3001, 98, table, c)
    k2, kc = bpe_cuda.flat_encode_slots(_t(data), 3001, 98, table, c)
    k2 = k2.to(torch.int32)
    starts = (k2 & 0xFF) != 0
    swapped = torch.where(starts, ((k2 & 0xFF) << 8) | (k2 >> 8), k2)
    assert starts.any()
    assert torch.equal(full.to(torch.int32), swapped) and torch.equal(fc, kc)


def test_exp_parts_rejects_an_unknown_variant(parts_setup):
    _, table, data = parts_setup
    with pytest.raises(ValueError, match="unknown variant"):
        exp_parts.flat_parts("swap", _t(data), 10, -1, table, torch.zeros((1, 1), dtype=torch.int32))


# --- K2 chained through its carry ---------------------------------------------


@pytest.mark.parametrize("n,next_byte,carry", [(4096, -1, 0), (3001, 98, 1), (0, -1, 1)])
def test_flat_encode_chained_equals_pallas(parts_setup, n, next_byte, carry):
    _, table, data = parts_setup
    enc = bpe_pallas.PallasFlatEncoder(
        JaxMergeTable.build(PARTS_MERGES), interpret=True, capacity_bytes=4096,
        rows_per_block=PARTS_RPB)
    data = data.copy()
    if n:
        data[n - 1] = 97
    buf = np.zeros(((PARTS_BLOCKS * PARTS_RPB + 8) * LANES,), np.uint8)
    buf[: data.shape[0]] = data
    out, c = bpe_pallas.flat_encode_chained(
        enc.params(n, next_byte), enc.segs, jnp.asarray(np.full((1, 1), carry, np.int32)),
        jnp.asarray(buf.reshape(-1, LANES)), enc.e1, enc.e2, k=3, interpret=True,
        mode=enc.mode, rows_per_block=PARTS_RPB)
    slots, got_c = bpe_cuda.flat_encode_chained(
        _t(data), n, next_byte, table, torch.tensor([[carry]], dtype=torch.int32), k=3)
    assert np.array_equal(slots.numpy()[:n], np.asarray(out).reshape(-1)[:n])
    assert np.array_equal(got_c.numpy(), np.asarray(c))


# --- the entry points, as processes ----------------------------------------------


@pytest.mark.parametrize("tool", ["exp_chain", "exp_sweep", "exp_parts"])
def test_entry_point_runs_on_the_cpu(tool):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", f"blt_tpu_torch.tools.{tool}", "--device", "cpu",
         "--size-mib", "1", "--k", "2"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["tool"] == tool and out["exact"] is True
    assert out["device"] == {"type": "cpu"} and out["size_bytes"] == 1 << 20
    for row in out["rows"]:
        assert row["exact"] is True and row["graph"] is None
        assert row["eager"]["ms_per_launch"]["n"] == 5 and row["bound_ms"] > 0
        assert row["k"] == (exp_chain.BPE_K if row["kernel"] == "K2" and tool == "exp_chain"
                            else 2)
    if tool == "exp_sweep":
        assert [(r["rpb"], r["blocks"]) for r in out["rows"][:3]] == [(512, 16), (2048, 4), (8192, 1)]
