"""The design probes T2 and T10 of the torch port against the JAX tools, on
the CPU.

T2 (``blt_tpu_torch.tools.exp_opt``) and T10 (``blt_tpu_torch.tools.exp_chd``)
are flag sets of K2's pass (``bpe_cuda.FLAT_PASSES``) and, for T10's
``noscan2``, ``tools_cuda.row_scan``. On the CPU the port's wrappers run
their plain PyTorch versions, held here against the JAX tools' own kernel
bodies (``tools/exp_opt.py::make_kernel``, ``tools/exp_chd.py::make_kernel``)
wrapped in ``pl.pallas_call(..., interpret=True)`` with the tools' BlockSpecs:
T2 at 128 rows per block on two blocks (its ``p2`` scan needs at least 128
rows), T10 at 8 and 16. Every comparison is exact (tolerance 0); inputs come
from numpy ``default_rng(seed)``.

T2's body probes cuckoo planes (``force_mode="cuckoo"``; the tool's own
``main`` hands it CHD planes, ROADMAP.md §3) and lacks the ``e != -1`` test,
so a pair (255, 255) hits an empty slot: its inputs hold no byte 255. T10's
body probes the CHD planes its tool builds. The port's lookup is the dense
wire table in both (the same function). Slots are compared over the n valid
positions, where the Pallas padding blocks differ by design (ROADMAP.md §3),
except ``noscan2``, whose block carry the port reproduces everywhere.
"""

import importlib.util
import os
import re
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
from blt_tpu.utils import compcache
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_cuda, tools_cuda
from blt_tpu_torch.ops.tables import wire_table
from blt_tpu_torch.tools import exp_chd, exp_opt

REPO = Path(__file__).resolve().parent.parent
LANES = 128
MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259,
          (32, 104): 260, (104, 104): 261, (112, 120): 262, (120, 0): 263,
          (0, 64): 264, (64, 97): 265}
ALPHABET = b"aabbcc hhpx\x00ab@"  # no byte 255: T2's body would misread it


def _jax_tool(name):
    """A JAX tool module of ``tools/``, loaded by path (not a package); the
    fixed checkout path the tools put on ``sys.path`` is taken back out, and
    the compile cache a tool enables is left as it was."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved, enabled = sys.path[:], compcache._enabled
    compcache._enabled = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
        compcache._enabled = enabled
    return mod


JAX_OPT = _jax_tool("exp_opt")
JAX_CHD = _jax_tool("exp_chd")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(ALPHABET, np.uint8), n).astype(np.uint8)


def _data3(data):
    """The tools' input buffer: the batch, then 8 zero halo rows."""
    rows = data.shape[0] // LANES
    buf = np.zeros(((rows + 8) * LANES,), np.uint8)
    buf[: data.shape[0]] = data
    return jnp.asarray(buf.reshape(rows + 8, LANES))


def _carry(carry):
    return torch.tensor([[carry]], dtype=torch.int32)


# --- T2 ---------------------------------------------------------------------------

OPT_RPB = 128
OPT_BYTES = 2 * OPT_RPB * LANES  # two Pallas blocks, 32 KiB
# the tool's variants: (p2, hoist, swap)
OPT_FLAGS = {"base": (False, False, False), "p2": (True, False, False),
             "p2+hoist": (True, True, False), "p2+hoist+swap": (True, True, True)}


def _preswap(e):
    """The tool's ``preswap``: each entry's value half byteswapped."""
    e = np.asarray(e)
    val = e & 0xFFFF
    return jnp.asarray(((e & np.int32(-65536)) | ((val & 0xFF) << 8) | (val >> 8)).astype(np.int32))


def _opt_pallas(variant, data, n, next_byte, carry, enc, k=1):
    """exp_opt.chain's grid spec in interpret mode, k calls chained through
    the carry."""
    p2, hoist, swap = OPT_FLAGS[variant]
    e1, e2 = (_preswap(enc.e1), _preswap(enc.e2)) if swap else (enc.e1, enc.e2)
    segs = e1.shape[0]
    rpb = OPT_RPB
    total_rows = data.shape[0] // LANES
    kernel, nsr = JAX_OPT.make_kernel(p2, hoist, swap, segs, rpb)
    call = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(total_rows // rpb,),
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
            scratch_shapes=[
                pltpu.SMEM((1,), jnp.int32),
                pltpu.VMEM((nsr, LANES), jnp.int32),
                pltpu.VMEM((nsr, LANES), jnp.int32),
            ],
        ),
        out_shape=(
            jax.ShapeDtypeStruct((total_rows, LANES), jnp.uint16),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        interpret=True,
    )
    data3 = _data3(data)
    c = jnp.asarray(np.full((1, 1), carry, np.int32))
    for _ in range(k):
        out, c = call(enc.params(n, next_byte), c, data3, data3, e1, e2)
    return np.asarray(out).reshape(-1), np.asarray(c)


@pytest.fixture(scope="module")
def opt_setup():
    enc = bpe_pallas.PallasFlatEncoder(JaxMergeTable.build(MERGES), interpret=True,
                                       capacity_bytes=OPT_BYTES, rows_per_block=OPT_RPB,
                                       force_mode="cuckoo")
    assert enc.mode == "cuckoo"
    return enc, wire_table(MergeTable.build(MERGES).dense), _data(40, OPT_BYTES)


@pytest.mark.parametrize("variant", list(exp_opt.VARIANTS))
@pytest.mark.parametrize("carry,n,next_byte", [(0, OPT_BYTES, -1), (1, 30001, 98)])
def test_opt_variants_equal_tool_body(opt_setup, variant, carry, n, next_byte):
    enc, table, data = opt_setup
    data = data.copy()
    data[n - 1] = 97  # (97, next_byte 98) is a rule
    ref_slots, ref_carry = _opt_pallas(variant, data, n, next_byte, carry, enc)
    vt = exp_opt.variant_table(variant, table)
    got_slots, got_carry = exp_opt.opt_pass(variant, _t(data), n, next_byte, vt, _carry(carry))
    assert np.array_equal(got_slots.numpy()[:n], ref_slots[:n])
    assert np.array_equal(got_carry.numpy(), ref_carry)


def test_opt_chain_equals_tool_chain(opt_setup):
    """Two calls chained through the carry, as the tool's ``chain``; the
    batch ends mid-tile with a rule pair across its end."""
    enc, table, data = opt_setup
    n = 20000
    data = data.copy()
    data[n - 1] = 97
    for variant in ("p2", "p2+hoist+swap"):
        ref_slots, ref_carry = _opt_pallas(variant, data, n, 98, 1, enc, k=2)
        vt = exp_opt.variant_table(variant, table)
        got_slots, got_carry = exp_opt.chain(variant, _t(data), n, 98, vt, _carry(1), 2)
        assert np.array_equal(got_slots.numpy()[:n], ref_slots[:n])
        assert np.array_equal(got_carry.numpy(), ref_carry)


def test_opt_variants_are_k2_with_starts_swapped(opt_setup):
    """Every T2 variant is K2's slot with each merge start's value
    byteswapped (the raw rule value), at every capacity slot."""
    _, table, data = opt_setup
    merged = 0
    for carry, n, nb in ((0, OPT_BYTES, -1), (1, 30001, 98), (1, 0, -1), (0, 1, 97)):
        k2, k2_c = bpe_cuda.flat_encode_slots(_t(data), n, nb, table, _carry(carry))
        k2 = k2.to(torch.int32)
        swapped = torch.where((k2 & 0xFF) != 0, ((k2 & 0xFF) << 8) | (k2 >> 8), k2)
        merged += int((swapped != k2).sum())
        for variant in exp_opt.VARIANTS:
            vt = exp_opt.variant_table(variant, table)
            slots, c = exp_opt.opt_pass(variant, _t(data), n, nb, vt, _carry(carry))
            assert torch.equal(slots.to(torch.int32), swapped) and torch.equal(c, k2_c), variant
    assert merged > 1000  # merges happened, so the swap is seen


def test_opt_swap_table_is_the_raw_rule_values(opt_setup):
    _, table, _ = opt_setup
    raw = exp_opt.variant_table("p2+hoist+swap", table).to(torch.int32)
    assert int(raw[97 * 256 + 98]) == 256 and int(raw[98 * 256 + 99]) == 257
    assert exp_opt.variant_table("p2", table) is table
    with pytest.raises(ValueError, match="unknown variant"):
        exp_opt.variant_table("p3", table)


# --- T10 --------------------------------------------------------------------------

CHD_BYTES = 64 * LANES  # 8 Pallas blocks of 8 rows, 4 of 16


def _chd_pallas(variant, data, n, next_byte, carry, enc, rpb, k=1):
    """exp_chd.chain's grid spec in interpret mode, k calls chained through
    the carry."""
    total_rows = data.shape[0] // LANES
    call = pl.pallas_call(
        JAX_CHD.make_kernel(variant),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(total_rows // rpb,),
            in_specs=[
                pl.BlockSpec((1, 1), lambda i, p, s: (0, 0), memory_space=pltpu.SMEM),
                pl.BlockSpec((rpb, LANES), lambda i, p, s: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((8, LANES), lambda i, p, s: ((i + 1) * rpb // 8, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
            ],
            out_specs=(
                pl.BlockSpec((rpb, LANES), lambda i, p, s: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1), lambda i, p, s: (0, 0), memory_space=pltpu.SMEM),
            ),
            scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        ),
        out_shape=(
            jax.ShapeDtypeStruct((total_rows, LANES), jnp.uint16),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        interpret=True,
    )
    data3 = _data3(data)
    c = jnp.asarray(np.full((1, 1), carry, np.int32))
    for _ in range(k):
        out, c = call(enc.params(n, next_byte), enc.segs, c, data3, data3, enc.e1, enc.e2)
    return np.asarray(out).reshape(-1), np.asarray(c)


@pytest.fixture(scope="module")
def chd_setup():
    """The CHD placement the tool's body probes at 8 and 16 rows per
    block, the port's wire table, and text with long runs of matches (so
    rows open inside a run and noscan2's row-local scan shows)."""
    table = JaxMergeTable.build(MERGES)
    encs = {rpb: bpe_pallas.PallasFlatEncoder(table, interpret=True, capacity_bytes=CHD_BYTES,
                                              rows_per_block=rpb) for rpb in (8, 16)}
    assert all(e.mode in ("chd", "perfect") for e in encs.values())
    data = _data(41, CHD_BYTES)
    data[1000:1300] = 97  # a run of (97, 97) over row and block edges
    data[4090:4200:2] = 98  # (97, 98) (98, 97) ...
    return encs, wire_table(MergeTable.build(MERGES).dense), data


@pytest.mark.parametrize("variant,rpb", [("prod", 16), ("novalid", 16), ("noscan2", 8),
                                         ("noscan2", 16)])
@pytest.mark.parametrize("carry,n,next_byte", [(0, CHD_BYTES, -1), (1, 5001, -1),
                                               (1, 5001, 98), (0, 1100, 97)])
def test_chd_variants_equal_tool_body(chd_setup, variant, rpb, carry, n, next_byte):
    encs, table, data = chd_setup
    data = data.copy()
    data[n - 1] = 97  # (97, 98) and (97, 97) are rules
    ref_slots, ref_carry = _chd_pallas(variant, data, n, next_byte, carry, encs[rpb], rpb)
    got_slots, got_carry = exp_chd.chd_pass(variant, _t(data), n, next_byte, table,
                                            _carry(carry), rpb)
    upto = CHD_BYTES if variant == "noscan2" else n
    assert np.array_equal(got_slots.numpy()[:upto], ref_slots[:upto])
    assert np.array_equal(got_carry.numpy(), ref_carry)


def test_chd_noscan2_chain_equals_tool_chain(chd_setup):
    """Three calls chained through the carry, each block's carry the one
    before's start at its last position below n."""
    encs, table, data = chd_setup
    for rpb in (8, 16):
        ref = _chd_pallas("noscan2", data, 3001, 97, 1, encs[rpb], rpb, k=3)
        got = exp_chd.chain("noscan2", _t(data), 3001, 97, table, _carry(1), 3, rpb)
        assert np.array_equal(got[0].numpy(), ref[0]) and np.array_equal(got[1].numpy(), ref[1])


def test_chd_noscan2_differs_from_prod_and_depends_on_rpb(chd_setup):
    """Dropping the scan's cross-row phase changes slots where a row opens
    inside a run of matches, and where that happens depends on rpb."""
    _, table, data = chd_setup
    prod = exp_chd.chd_pass("prod", _t(data), CHD_BYTES, -1, table, _carry(0))[0]
    by_rpb = {rpb: exp_chd.chd_pass("noscan2", _t(data), CHD_BYTES, -1, table, _carry(0), rpb)[0]
              for rpb in (8, 16, 64)}
    assert all((s != prod).any() for s in by_rpb.values())
    assert not torch.equal(by_rpb[8], by_rpb[16]) or not torch.equal(by_rpb[16], by_rpb[64])


def test_chd_prod_is_k2_and_novalid_differs_only_at_the_last_pair(chd_setup):
    _, table, data = chd_setup
    data = data.copy()
    data[2999] = 99  # (99, 0): no rule; (99, 97) is one
    for carry, n, nb in ((0, CHD_BYTES, -1), (1, 3000, 97), (1, 0, -1)):
        k2 = bpe_cuda.flat_encode_slots(_t(data), n, nb, table, _carry(carry))
        prod = exp_chd.chd_pass("prod", _t(data), n, nb, table, _carry(carry))
        assert torch.equal(prod[0], k2[0]) and torch.equal(prod[1], k2[1])
    # next_byte -1 makes the last pair (d, 0) under novalid
    for last, same in ((99, True), (120, False)):  # (120, 0) is a rule
        data[2999] = last
        prod = exp_chd.chd_pass("prod", _t(data), 3000, -1, table, _carry(0))
        novalid = exp_chd.chd_pass("novalid", _t(data), 3000, -1, table, _carry(0))
        assert torch.equal(prod[0][:2999], novalid[0][:2999])
        assert torch.equal(prod[0][:3000], novalid[0][:3000]) == same


def test_chd_passes_refuse_what_their_kernels_do_not_take(chd_setup):
    _, table, data = chd_setup
    with pytest.raises(ValueError, match="unknown variant"):
        exp_chd.chd_pass("scan2", _t(data), 10, -1, table, _carry(0))
    with pytest.raises(ValueError, match="whole blocks"):
        exp_chd.chd_pass("noscan2", _t(data), 10, -1, table, _carry(0), 1024)
    with pytest.raises(ValueError, match="multiple of 8"):
        exp_chd.chd_pass("noscan2", _t(data), 10, -1, table, _carry(0), 12)


# --- the flat pass's flag sets ---------------------------------------------------------


def test_flat_bpe_instantiates_exactly_the_named_flag_sets():
    """``flat_bpe.cu`` instantiates the flag sets of ``FLAT_PASSES`` and no
    other (32 instantiations became 12); K2's is 131 (lookup, scan,
    valid)."""
    text = (REPO / "blt_tpu_torch" / "csrc" / "flat_bpe.cu").read_text()
    listed = re.search(r"FlatSets = std::integer_sequence<int,([^>]*)>", text)[1]
    in_c = [int(x) for x in listed.split(",")]
    assert sorted(in_c) == sorted(f.bits for f in bpe_cuda.FLAT_PASSES.values())
    assert len(set(in_c)) == len(in_c)
    assert bpe_cuda.FlatFlags().bits == 131


def test_wrappers_count_no_launch_on_the_cpu(opt_setup, chd_setup):
    _, table, data = chd_setup
    bpe_cuda.reset_launches()
    tools_cuda.reset_launches()
    for variant in exp_opt.VARIANTS:
        exp_opt.chain(variant, _t(data), 100, -1, table, _carry(0), 2)
    for variant in exp_chd.VARIANTS:
        exp_chd.chain(variant, _t(data), 100, -1, table, _carry(0), 2, 8)
    assert all(v == 0 for m in (bpe_cuda, tools_cuda) for v in m.launches.values())


# --- the entry points, as processes ------------------------------------------------------


def _run_tool(tool, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the suite's other workers share the cores
    return subprocess.run([sys.executable, "-m", f"blt_tpu_torch.tools.{tool}", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


@pytest.mark.parametrize("tool", ["exp_opt", "exp_chd"])
def test_entry_point_runs_on_the_cpu(tool):
    import json

    r = _run_tool(tool, "--device", "cpu", "--size-mib", "1", "--k", "2")
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["tool"] == tool and out["exact"] is True
    assert out["device"] == {"type": "cpu"} and out["size_bytes"] == 1 << 20
    for row in out["rows"]:
        assert row["exact"] is True and row["graph"] is None and row["bound_ms"] > 0
        assert row["eager"]["ms_per_launch"]["n"] == 5 and row["library_ms"] is None
    names = [(r["name"], r.get("rpb")) for r in out["rows"]]
    if tool == "exp_opt":
        assert names == [(v, None) for v in exp_opt.VARIANTS]
    else:
        assert names == [("prod", 512), ("prod", 1024), ("prod", 2048), ("noscan2", 1024),
                         ("novalid", 1024)]


@pytest.mark.parametrize("tool", ["exp_opt", "exp_chd"])
def test_entry_point_without_a_card_names_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run_tool(tool, "--size-mib", "1")
    assert r.returncode != 0 and "CUDA" in r.stderr
