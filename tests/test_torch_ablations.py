"""The ablations T4 and T6 of the torch port against the JAX tools, on the CPU.

T4 (``blt_tpu_torch.tools.exp_mp_ablate``: K4's round under other flags,
and ``tools_cuda.copy_tokens``) and T6 (``blt_tpu_torch.tools.exp_scan``:
K2's pass under other flags, and ``tools_cuda.block_scan``): on the CPU the
port's wrappers run their plain PyTorch versions, held here against
the JAX tools' own kernel bodies (``tools/exp_mp_ablate.py::
make_variant_kernel``, ``tools/exp_scan.py::_variant_body``) wrapped in
``pl.pallas_call(..., interpret=True)`` with the tools' BlockSpecs, at a few
blocks of 8 rows, chained as the tools chain them. T6's lookup is the tool's
CHD probe on the JAX side and the dense wire table in the port (the same
function). Every comparison is exact (tolerance 0). Inputs come from numpy
``default_rng(seed)``. The CUDA kernels themselves are held against the
plain versions by tests/test_torch_gpu.py and ``chip_smoke.py``.

Loading ``tools/exp_mp_ablate.py`` runs its ``enable_compilation_cache()``,
which would point JAX's persistent compile cache into the home directory;
the loader marks the cache as enabled for the load, so it writes nothing
outside the checkout (and restores the flag). Its ``from bench import
make_corpus`` reads the checkout's ``bench.py``, which does no work at
import.

Then both tools run as processes on the CPU.
"""

import importlib.util
import json
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
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda, tools_cuda
from blt_tpu_torch.ops.tables import cuckoo_planes, planes_from_jax, wire_table
from blt_tpu_torch.tools import exp_mp_ablate, exp_scan

REPO = Path(__file__).resolve().parent.parent
LANES = 128
RPB = 8
BLOCKS = 4


def _jax_tool(name):
    """A JAX tool module of ``tools/``, loaded by path (not a package); the
    fixed checkout path the tools put on ``sys.path`` is taken back out, and
    the compile cache a tool enables at load is left as it was."""
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


JAX_ABLATE = _jax_tool("exp_mp_ablate")
JAX_SCAN = _jax_tool("exp_scan")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- T4: the token pass's ablation ---------------------------------------------


def _ablate_pallas(variant, tokens, n, enc, halo, k):
    """exp_mp_ablate._one_call's grid spec in interpret mode, chained k times
    as its ``chained_call`` chains it: each output, with the 8 halo rows
    re-attached, is the next input."""
    total_rows = BLOCKS * RPB
    data3 = jnp.asarray(np.concatenate([tokens.reshape(total_rows, LANES), halo]))
    params = jnp.asarray(np.array([n, enc.a1, enc.a2, enc.shift, 0, 0, 0, 0], np.int32))
    call = pl.pallas_call(
        JAX_ABLATE.make_variant_kernel(variant),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(BLOCKS,),
            in_specs=[
                pl.BlockSpec((RPB, LANES), lambda i, params: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((8, LANES), lambda i, params: ((i + 1) * RPB // 8, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((RPB, LANES), lambda i, params: (i, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        ),
        out_shape=jax.ShapeDtypeStruct((total_rows, LANES), jnp.int32),
        interpret=True,
    )
    for _ in range(k):
        out = call(params, data3, data3, enc.k1, enc.v1, enc.k2, enc.v2)
        data3 = jnp.concatenate([out, data3[-8:]], axis=0)
    return np.asarray(out).reshape(-1)


@pytest.fixture(scope="module")
def ablate_setup():
    """The tool's four-rule hierarchical table on both sides, and tokens
    over its symbols with tombstones, 0xFFFF and other high tokens."""
    enc = bpe_pallas.PallasTokenEncoder(JaxMergeTable.build(exp_mp_ablate.HIER), interpret=True,
                                        capacity_tokens=BLOCKS * RPB * LANES, rows_per_block=RPB)
    planes = cuckoo_planes(MergeTable.build(exp_mp_ablate.HIER))
    theirs = planes_from_jax(enc.k1, enc.v1, enc.k2, enc.v2, enc.a1, enc.a2)
    assert (planes.a1, planes.a2, planes.shift) == (theirs.a1, theirs.a2, theirs.shift)
    assert all(torch.equal(getattr(planes, f), getattr(theirs, f)) for f in ("k1", "v1", "k2", "v2"))
    rng = np.random.default_rng(30)
    symbols = np.array([97, 98, 99, 32, 256, 257, 258, 259, -1, -2, 0xFFFF, 40000, 11, 3],
                       np.int32)
    tokens = rng.choice(symbols, BLOCKS * RPB * LANES).astype(np.int32)
    tokens[1000:1200] = 97  # a run of (97, 97): no rule; (97, 98) pairs around it
    tokens[1200:1300:2] = 98
    halo = rng.integers(0, 1 << 20, (8, LANES), dtype=np.int32)
    return enc, planes, tokens, halo


@pytest.mark.parametrize("variant", list(exp_mp_ablate.VARIANTS))
@pytest.mark.parametrize("n", [BLOCKS * RPB * LANES, 3001, 1])
def test_token_parts_equal_tool_body(ablate_setup, variant, n):
    enc, planes, tokens, halo = ablate_setup
    ref = _ablate_pallas(variant, tokens, n, enc, halo, 3)
    got = exp_mp_ablate.chain(variant, _t(tokens), n, planes, 3)
    assert np.array_equal(got.numpy(), ref)
    plain = exp_mp_ablate.chain_plain(variant, _t(tokens), n, planes, 3)
    assert torch.equal(plain, got)


def test_token_parts_full_is_k4(ablate_setup):
    _, planes, tokens, _ = ablate_setup
    for n in (0, 2, 3001, tokens.shape[0]):
        assert torch.equal(exp_mp_ablate.token_parts("full", _t(tokens), n, planes),
                           multipass_cuda.token_pass(_t(tokens), n, planes))


def test_token_parts_merge_something(ablate_setup):
    """Each variant but copy changes the tokens, so the chains above compare
    merged output, tombstones included."""
    _, planes, tokens, _ = ablate_setup
    first = exp_mp_ablate.token_parts("full", _t(tokens), tokens.shape[0], planes)
    assert (first == 256).sum() > (_t(tokens) == 256).sum()
    for variant in exp_mp_ablate.VARIANTS:
        out = exp_mp_ablate.token_parts(variant, _t(tokens), tokens.shape[0], planes)
        assert torch.equal(out, _t(tokens)) == (variant == "copy"), variant


def test_token_parts_rejects_an_unknown_variant(ablate_setup):
    _, planes, tokens, _ = ablate_setup
    with pytest.raises(ValueError, match="unknown variant"):
        exp_mp_ablate.token_parts("gap", _t(tokens), 10, planes)


# --- T6: the flat pass's ablation ------------------------------------------------

SCAN_MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259,
               (32, 104): 260, (104, 104): 261, (112, 120): 262, (120, 0): 263,
               (0, 64): 264, (64, 97): 265, (255, 255): 0xFFFF, (97, 255): 266}
SCAN_ALPHABET = b"aabbcc hhpx\x00ab@\xff"


def _halo_map(rpb, tool_map):
    """The 8-row halo block the tool maps (``i + 1``: rows 8(i+1)) or the
    next block's first rows (``(i + 1) * rpb // 8``, as K2's own map)."""
    if tool_map:
        return lambda i: (i + 1, 0)
    return lambda i: ((i + 1) * rpb // 8, 0)


def _scan_pallas(variant, data, n, next_byte, carry, enc, k, rpb=RPB, tool_map=True):
    """exp_scan._pallas's grid spec in interpret mode, k calls chained
    through the carry as its ``chain`` does."""
    total_rows = data.shape[0] // LANES
    buf = np.zeros(((total_rows + 8) * LANES,), np.uint8)
    buf[: data.shape[0]] = data
    data3 = jnp.asarray(buf.reshape(total_rows + 8, LANES))
    call = pl.pallas_call(
        JAX_SCAN._variant_body(variant),
        grid=(total_rows // rpb,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((8, LANES), _halo_map(rpb, tool_map), memory_space=pltpu.VMEM),
            pl.BlockSpec((enc.e1.shape[0], LANES), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((enc.e2.shape[0], LANES), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=(
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((total_rows, LANES), jnp.uint16),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        interpret=True,
    )
    c = jnp.asarray(np.full((1, 1), carry, np.int32))
    for _ in range(k):
        out, c = call(enc.params(n, next_byte), c, data3, data3, enc.e1, enc.e2)
    return np.asarray(out).reshape(-1), np.asarray(c)


@pytest.fixture(scope="module")
def scan_setup():
    """The CHD placement the tool's body probes, and the port's wire table
    of the same rules (the rule (255, 255) -> 0xFFFF included)."""
    enc = bpe_pallas.PallasFlatEncoder(JaxMergeTable.build(SCAN_MERGES), interpret=True,
                                       capacity_bytes=BLOCKS * RPB * LANES, rows_per_block=RPB)
    assert enc.mode in ("chd", "perfect"), enc.mode
    table = wire_table(MergeTable.build(SCAN_MERGES).dense)
    rng = np.random.default_rng(31)
    data = rng.choice(np.frombuffer(SCAN_ALPHABET, np.uint8), BLOCKS * RPB * LANES)
    return enc, table, data.astype(np.uint8)


@pytest.mark.parametrize("variant", list(exp_scan.VARIANTS))
@pytest.mark.parametrize("carry", [0, 1])
@pytest.mark.parametrize("n,next_byte", [(4096, -1), (3001, 98), (3001, -1)])
def test_scan_parts_equal_tool_body(scan_setup, variant, carry, n, next_byte):
    enc, table, data = scan_setup
    data = data.copy()
    data[n - 1] = 97  # (97, next_byte 98) is a rule
    ref_slots, ref_carry = _scan_pallas(variant, data, n, next_byte, carry, enc, 2)
    c = torch.tensor([[carry]], dtype=torch.int32)
    got_slots, got_carry = exp_scan.chain(variant, _t(data), n, next_byte, table, c, 2, RPB)
    assert np.array_equal(got_slots.numpy()[:n], ref_slots[:n])
    assert np.array_equal(got_carry.numpy(), ref_carry)
    plain = exp_scan.chain_plain(variant, _t(data), n, next_byte, table, c, 2, RPB)
    assert torch.equal(plain[0], got_slots) and torch.equal(plain[1], got_carry)


def test_scan_parts_full_is_k2(scan_setup):
    _, table, data = scan_setup
    for carry, n, nb in ((0, 4096, -1), (1, 3001, 98), (1, 0, -1)):
        c = torch.tensor([[carry]], dtype=torch.int32)
        got = exp_scan.scan_parts("full", _t(data), n, nb, table, c)
        k2 = bpe_cuda.flat_encode_slots(_t(data), n, nb, table, c)
        assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1])


def test_scan16_differs_where_a_block_opens_with_matches_after_a_start(scan_setup):
    """scan16 keeps no parity between blocks: where a block opens with a run
    of (97, 97) matches after a start (carry_in 1 at block 0; block 1 after
    block 0 ends in a start), it starts a merge at the block's first
    position and full does not. Both as the tool's body computes them."""
    enc, table, _ = scan_setup
    data = np.full(BLOCKS * RPB * LANES, ord("x"), np.uint8)
    block = RPB * LANES
    data[:64] = 97
    data[block - 3 : block + 64] = 97  # block 0 ends in a run that goes on
    c = torch.tensor([[1]], dtype=torch.int32)
    slots = {}
    for variant in ("scan16", "full"):
        ref, ref_c = _scan_pallas(variant, data, data.shape[0], -1, 1, enc, 1)
        got, got_c = exp_scan.scan_parts(variant, _t(data), data.shape[0], -1, table, c, RPB)
        assert np.array_equal(got.numpy(), ref) and np.array_equal(got_c.numpy(), ref_c)
        slots[variant] = ref
    differs = np.nonzero(slots["scan16"] != slots["full"])[0]
    assert set(differs) & set(range(0, 64)) and set(differs) & set(range(block, block + 64))
    assert not set(differs) - set(range(0, 64)) - set(range(block, block + 64))


def test_scan_parts_halo_at_rpb_16_fixes_the_tool_map(scan_setup):
    """At rows_per_block 16 the tool's halo map (i + 1) hands a block's last
    position rows 8(i+1), inside its own block, as the next byte. The port
    pairs it with the next block's first byte: the tool's body under K2's
    map ((i + 1) * rpb // 8) equals the port; under its own it differs at a
    block's last position."""
    enc, table, _ = scan_setup
    rpb = 16
    block = rpb * LANES
    data = np.full(2 * block, ord("x"), np.uint8)
    data[block - 1] = 97  # the last byte of block 0
    data[block] = 98  # the first byte of block 1: (97, 98) is a rule
    data[8 * LANES] = ord("h")  # what the tool's map reads: (97, h) is none
    c = torch.tensor([[0]], dtype=torch.int32)
    got, got_c = exp_scan.scan_parts("full", _t(data), data.shape[0], -1, table, c, rpb)
    fixed, fixed_c = _scan_pallas("full", data, data.shape[0], -1, 0, enc, 1, rpb, tool_map=False)
    tool, _ = _scan_pallas("full", data, data.shape[0], -1, 0, enc, 1, rpb, tool_map=True)
    assert np.array_equal(got.numpy(), fixed) and np.array_equal(got_c.numpy(), fixed_c)
    assert list(np.nonzero(tool != fixed)[0]) == [block - 1, block]
    assert got[block - 1] != (97 << 8) and got[block] == 0  # a merge, its byte consumed


def test_scan_parts_refuse_what_their_kernels_do_not_take(scan_setup):
    _, table, data = scan_setup
    c = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown variant"):
        exp_scan.scan_parts("scan8", _t(data), 10, -1, table, c)
    with pytest.raises(ValueError, match="whole blocks"):
        exp_scan.scan_parts("scan16", _t(data), 10, -1, table, c, 1024)
    with pytest.raises(ValueError, match="multiple of 8"):
        exp_scan.scan_parts("swarpack", _t(data), 10, -1, table, c, 12)
    with pytest.raises(ValueError, match="whole rows"):
        exp_scan.scan_parts("noshifts", _t(data[:4000]), 10, -1, table, c)


@pytest.mark.parametrize("flags,header,passes", [
    (bpe_cuda.FlatFlags, "flat_pass.cuh", {
        "flat_bpe": 131, "parts_emit": 132, "parts_noscan": 133, "parts_nolookup": 134,
        "parts_full": 135, "scan_parts_noscan": 137, "scan_parts_nolookup": 130,
        "scan_parts_noshifts": 147, "opt_p2": 167, "opt_hoist": 231, "opt_swap": 227,
        "chd_novalid": 3}),
    (multipass_cuda.TokenFlags, "token_pass.cuh", {
        "token_pass_lookback": 15, "token_pass": 7, "token_parts_noscan": 5,
        "token_parts_nolookup": 6, "token_parts_noshift": 3}),
])
def test_flag_bits_are_the_c_entries(flags, header, passes):
    """The flag sets' bits are the ``kFlag*`` values of the header whose
    one C entry takes them (K2 is 131, K4 15, its three-launch design 7),
    field by field; the sets each entry instantiates are held to the tables
    by ``test_torch_flat_opt.py`` and ``test_torch_lookback.py``."""
    text = (REPO / "blt_tpu_torch" / "csrc" / header).read_text()
    in_c = {m[1].lower(): int(m[2]) for m in re.finditer(r"kFlag(\w+) = (\d+)", text)}
    assert in_c == {f.replace("_", ""): 1 << i for i, f in enumerate(flags._fields)}
    table = bpe_cuda.FLAT_PASSES if flags is bpe_cuda.FlatFlags else multipass_cuda.TOKEN_PASSES
    assert {name: f.bits for name, f in table.items()} == passes


def test_a_flag_set_no_pass_uses_is_refused(scan_setup, ablate_setup):
    _, table, data = scan_setup
    _, planes, tokens, _ = ablate_setup
    c = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="not a flat pass"):
        bpe_cuda.flat_encode_slots(_t(data), 10, -1, table, c, bpe_cuda.FlatFlags(odd=True))
    with pytest.raises(ValueError, match="not a merge round"):
        multipass_cuda.token_pass(_t(tokens), 10, planes,
                                  multipass_cuda.TokenFlags(lookup=False, scan=False))


def test_wrappers_count_no_launch_on_the_cpu(scan_setup, ablate_setup):
    _, table, data = scan_setup
    _, planes, tokens, _ = ablate_setup
    modules = (bpe_cuda, multipass_cuda, tools_cuda)
    for m in modules:
        m.reset_launches()
    for variant in exp_scan.VARIANTS:
        exp_scan.chain(variant, _t(data), 100, -1, table, torch.zeros((1, 1), dtype=torch.int32),
                       2, RPB)
    for variant in exp_mp_ablate.VARIANTS:
        exp_mp_ablate.chain(variant, _t(tokens), 100, planes, 2)
    assert all(v == 0 for m in modules for v in m.launches.values())


# --- the entry points, as processes ------------------------------------------------


@pytest.mark.parametrize("tool", ["exp_mp_ablate", "exp_scan"])
def test_entry_point_runs_on_the_cpu(tool):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the suite's other workers share the cores
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
        assert row["exact"] is True and row["graph"] is None and row["bound_ms"] > 0
        assert row["eager"]["ms_per_launch"]["n"] == 5
    names = [(r["name"], r["rpb"]) for r in out["rows"]]
    if tool == "exp_scan":
        assert names == [(v, 1024) for v in exp_scan.VARIANTS]
    else:
        assert names[:7] == [(v, 512) for v in exp_mp_ablate.VARIANTS] + [
            ("full", 256), ("full", 1024)]
        assert [r["name"] for r in out["rows"][7:]] == [
            "sortkv", "cumsum", "gapsweep", "gapsweep", "plain_control"]
        assert out["rows"][4]["library_ms"] > 0  # copy beside clone()
