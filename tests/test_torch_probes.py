"""The probes T9 and T5 of the torch port against the JAX tools, on the CPU.

T9 (``tools_cuda.subgather``, the ``subgather`` rows of
``blt_tpu_torch.tools.exp_parts``) and T5 (``tools_cuda.op_mix``,
``blt_tpu_torch.tools.exp_pack``): on the CPU the port's wrappers run their
plain PyTorch versions, held here against the JAX tools' own kernel bodies
(``tools/exp_parts.py::_subgather_kernel``, ``tools/exp_pack.py::_mix_kernel``)
wrapped in ``pl.pallas_call(..., interpret=True)`` with the tools'
BlockSpecs, at a few blocks of 8 rows. Every comparison is exact (tolerance
0): every value is an integer. Inputs come from numpy ``default_rng(seed)``.
T9's two paths are mirrored on the host: each (block, slab) job's staged
rows, and the direct path's spans of vectors with the block divided out
once a span, gathered by that arithmetic alone against ``subgather_plain``
and the Pallas body. The CUDA kernels themselves are held against the plain
versions by tests/test_torch_gpu.py and ``chip_smoke.py``.

Then ``exp_pack`` runs as a process on the CPU (``exp_parts`` as a process
is in tests/test_torch_tools.py).
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

from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import exp_pack, exp_parts

REPO = Path(__file__).resolve().parent.parent
LANES = 128
RPB = 8
ROWS = 32  # 4 grid steps of 8 rows
INT32_MIN = -(2**31)


def _jax_tool(name):
    """A JAX tool module of ``tools/``, loaded by path (not a package); the
    fixed checkout path the tools put on ``sys.path`` is taken back out."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = sys.path[:]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


JAX_PARTS = _jax_tool("exp_parts")
JAX_PACK = _jax_tool("exp_pack")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- T9: subgather -------------------------------------------------------------


def _subgather_pallas(tbl, idx, rpb=RPB):
    """exp_parts.subgather's BlockSpecs, interpret mode."""
    rows = tbl.shape[0]
    out, done = pl.pallas_call(
        JAX_PARTS._subgather_kernel,
        grid=(rows // rpb,),
        in_specs=[
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=(
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((rows, LANES), jnp.int32),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(idx))
    return np.asarray(out), np.asarray(done)


def _table(seed, rows=ROWS):
    return np.random.default_rng(seed).integers(0, 1 << 30, (rows, LANES), dtype=np.int32)


@pytest.mark.parametrize("lo,hi", [(0, RPB), (0, 3), (-RPB, RPB), (-3 * RPB, 3 * RPB),
                                   (INT32_MIN, 2**31 - 1)])
@pytest.mark.parametrize("rpb", [8, 16])
def test_subgather_equals_tool_body(lo, hi, rpb):
    """In-block indices, and indices outside [0, rpb): interpret mode fills
    INT32_MIN past the block and wraps [-rpb, 0) from its end."""
    rng = np.random.default_rng(abs(lo) + hi + rpb)
    tbl = _table(1)
    idx = rng.integers(lo, hi, (ROWS, LANES), dtype=np.int64).astype(np.int32)
    ref_out, ref_done = _subgather_pallas(tbl, idx, rpb)
    got_out, got_done = tools_cuda.subgather(_t(tbl), _t(idx), rpb)
    assert np.array_equal(got_out.numpy(), ref_out)
    assert np.array_equal(got_done.numpy(), ref_done) and int(got_done) == ROWS // rpb - 1
    plain = tools_cuda.subgather_plain(_t(tbl), _t(idx), rpb)
    assert torch.equal(plain[0], got_out) and torch.equal(plain[1], got_done)


def test_subgather_out_of_block_values_as_in_interpret_mode():
    """Row 0 of block 1: indices 9 and -9 fill INT32_MIN, -1 wraps to the
    block's last row, -8 to its first, 7 is its last."""
    tbl = _table(2)
    idx = np.zeros((ROWS, LANES), np.int32)
    idx[RPB, :5] = [9, -9, -1, -8, 7]
    out, _ = tools_cuda.subgather(_t(tbl), _t(idx), RPB)
    row = out.numpy()[RPB, :5]
    assert list(row) == [INT32_MIN, INT32_MIN, tbl[2 * RPB - 1, 2], tbl[RPB, 3],
                         tbl[2 * RPB - 1, 4]]
    assert np.array_equal(row, _subgather_pallas(tbl, idx)[0][RPB, :5])


def test_subgather_in_range_is_torch_gather():
    rng = np.random.default_rng(3)
    tbl, idx = _table(3), rng.integers(0, RPB, (ROWS, LANES), dtype=np.int32)
    shape = (ROWS // RPB, RPB, LANES)
    got, _ = tools_cuda.subgather(_t(tbl), _t(idx), RPB)
    assert torch.equal(got.view(shape), torch.gather(_t(tbl).view(shape), 1, _t(idx).view(shape)))


def test_subgather_refuses_what_the_grid_would_not_cover():
    tbl = _t(_table(4, rows=12))
    with pytest.raises(ValueError, match="rows_per_block"):
        tools_cuda.subgather(tbl, tbl.clone(), RPB)
    with pytest.raises(ValueError, match="int32"):
        tools_cuda.subgather(tbl[:8], tbl[:8].to(torch.int64), RPB)
    with pytest.raises(ValueError, match="one shape"):
        tools_cuda.subgather(tbl[:8], tbl[:8].reshape(4, 256), RPB)


# --- T9's slab plan: the jobs subgather.cu launches, mirrored on the host -------

SUBGATHER_CU = REPO / "blt_tpu_torch" / "csrc" / "subgather.cu"


def test_subgather_mirror_constants_are_the_kernels():
    """subgather_plan's box height and shared-memory budget are the ones
    subgather.cu's slab path uses."""
    src = SUBGATHER_CU.read_text()
    consts = {name: int(np.prod([int(f) for f in v.split("*")])) for name, v in
              re.findall(r"constexpr int (kBoxRows|kSmemBytes) = ([\d *]+);", src)}
    assert consts == {"kBoxRows": tools_cuda.SUBGATHER_BOX_ROWS,
                      "kSmemBytes": tools_cuda.SUBGATHER_SMEM_BYTES}
    # the widths the C entry instantiates
    assert set(re.findall(r"case (\d+): return launch_slab", src)) == {"8", "4"}
    # the direct path's span, and its one division by rpb a CTA
    consts = {name: int(v) for name, v in
              re.findall(r"constexpr int (kDirectThreads|kDirectUnroll) = (\d+);", src)}
    assert consts == {"kDirectThreads": DIRECT_THREADS, "kDirectUnroll": DIRECT_UNROLL}
    direct = src[src.index("subgather_direct_kernel("):src.index("// cuTensorMapEncodeTiled")]
    assert direct.count("/ rpb") == 1 and "% rpb" not in direct
    assert "const int64_t block_row = first_row / rpb * rpb;" in direct
    # nothing but the slab and the direct path
    assert "cluster" not in src[src.index("#include"):]


@pytest.mark.parametrize("rpb, width", [(8, 8), (16, 8), (1000, 8), (1024, 8), (2048, 8),
                                        (3616, 8), (3617, 4), (4096, 4), (7232, 4),
                                        (7233, 0), (16384, 0)])
def test_subgather_plan_widths(rpb, width):
    """8 columns where a job's index tile and table slab fit, 4 (16-byte
    rows) for taller blocks, the direct path past that; a job always fits
    the budget."""
    plan = tools_cuda.subgather_plan(2 * rpb, rpb)
    assert plan["width"] == width
    if width:
        staged = -(-rpb // tools_cuda.SUBGATHER_BOX_ROWS) * tools_cuda.SUBGATHER_BOX_ROWS
        assert plan["smem_bytes"] == 2 * staged * width * 4 <= tools_cuda.SUBGATHER_SMEM_BYTES
        assert plan["jobs"] == 2 * LANES // width and plan["kernel"] == "subgather"
    else:
        assert plan["kernel"] == "subgather_direct"


def _slab_jobs(idx, rpb):
    """The plan and each (block, slab) job: (block, first column, the first
    and last row of the block its indices reach, None where they reach none,
    and the first row of each box it stages)."""
    plan = tools_cuda.subgather_plan(idx.shape[0], rpb)
    width, box = plan["width"], tools_cuda.SUBGATHER_BOX_ROWS
    jobs = []
    for b in range(idx.shape[0] // rpb):
        for col0 in range(0, LANES, width):
            x = idx[b * rpb : (b + 1) * rpb, col0 : col0 + width].astype(np.int64)
            r = np.where(x < 0, x + rpb, x)[(x >= -rpb) & (x < rpb)]
            if r.size == 0:
                jobs.append((b, col0, None, None, []))
            else:
                lo, hi = int(r.min()), int(r.max())
                jobs.append((b, col0, lo, hi, list(range(lo, hi + 1, box))))
    return plan, jobs


def _gather_by_plan(tbl, idx, rpb):
    """The slab path's arithmetic on the host: each job's slab holds only
    the boxes it stages (rows past the table arrive as zeros), and every
    element is gathered from its own job's slab."""
    plan, jobs = _slab_jobs(idx, rpb)
    width, box = plan["width"], tools_cuda.SUBGATHER_BOX_ROWS
    padded = np.concatenate([tbl, np.zeros((box, LANES), tbl.dtype)])
    out = np.full_like(idx, INT32_MIN)
    for b, col0, lo, hi, boxes in jobs:
        if lo is None:
            continue
        rows = [b * rpb + y + k for y in boxes for k in range(box)]
        slab = padded[rows, col0 : col0 + width]
        assert slab.nbytes <= plan["smem_bytes"] // 2  # the index tile takes the rest
        x = idx[b * rpb : (b + 1) * rpb, col0 : col0 + width].astype(np.int64)
        inside = (x >= -rpb) & (x < rpb)
        r = np.clip(np.where(x < 0, x + rpb, x) - lo, 0, slab.shape[0] - 1)
        got = np.take_along_axis(slab, r, axis=0)
        out[b * rpb : (b + 1) * rpb, col0 : col0 + width] = np.where(inside, got, INT32_MIN)
    return out


# index ranges by name, as (lo, hi) for rows_per_block rpb
SLAB_RANGES = {"block": lambda rpb: (0, rpb), "first3": lambda rpb: (0, 3),
               "wrap": lambda rpb: (-rpb, 0), "outside": lambda rpb: (rpb, 2**31 - 1),
               "int32": lambda rpb: (INT32_MIN, 2**31 - 1)}


@pytest.mark.parametrize("name", list(SLAB_RANGES))
@pytest.mark.parametrize("rpb", [8, 16, 1000, 1024])
def test_slab_jobs_stage_the_rows_they_reach(rpb, name):
    """Indices in the block, in [0, 3), in [-rpb, 0) (the wrap from the
    end), far outside (nothing staged) and over all of int32, on two blocks:
    each job stages its reached rows in boxes from the lowest, and gathering
    from the staged rows alone gives subgather_plain and the Pallas body in
    interpret mode. rpb 1000 is not a whole number of boxes."""
    lo, hi = SLAB_RANGES[name](rpb)
    rng = np.random.default_rng(rpb + len(name))
    rows = 2 * rpb
    tbl = _table(5, rows)
    idx = rng.integers(lo, hi, (rows, LANES), dtype=np.int64).astype(np.int32)
    plan, jobs = _slab_jobs(idx, rpb)
    box = tools_cuda.SUBGATHER_BOX_ROWS
    assert len(jobs) == plan["jobs"]
    for _, _, first, last, boxes in jobs:
        if first is None:
            assert name in ("outside", "int32") and boxes == []
            continue
        assert boxes[0] == first and boxes[-1] <= last < boxes[-1] + box
        assert len(boxes) == (last - first) // box + 1
    if name == "first3":
        assert all(boxes == [0] for *_, boxes in jobs)  # one box, not the block
    got = _gather_by_plan(tbl, idx, rpb)
    assert np.array_equal(got, tools_cuda.subgather_plain(_t(tbl), _t(idx), rpb)[0].numpy())
    assert np.array_equal(got, _subgather_pallas(tbl, idx, rpb)[0])


# subgather.cu's direct path: threads a CTA, int4 vectors a thread
DIRECT_THREADS, DIRECT_UNROLL = 256, 2


def _gather_by_spans(tbl, idx, rpb):
    """The direct path's arithmetic on the host: CTA k takes the
    DIRECT_UNROLL * DIRECT_THREADS vectors from k times that (4 elements of
    a row each), divides out the block of its first row once, and steps a
    vector's block on from there by whole blocks; each element reads its
    block's row, or is the fill. Returns the output and the most blocks a
    span's vectors stepped over."""
    span = DIRECT_UNROLL * DIRECT_THREADS
    nvec = idx.size // 4
    v = np.arange(nvec, dtype=np.int64)
    first_row = v // span * span * 4 // LANES
    block_row = first_row // rpb * rpb
    row = v * 4 // LANES
    steps = (row - block_row) // rpb  # the kernel's `while (row >= b + rpb) b += rpb`
    b = block_row + steps * rpb
    assert ((b <= row) & (row < b + rpb)).all()
    x = idx.reshape(nvec, 4).astype(np.int64)
    r = np.where(x < 0, x + rpb, x)
    inside = (x >= -rpb) & (x < rpb)
    col = (v * 4 % LANES)[:, None] + np.arange(4)
    src = np.where(inside, b[:, None] + r, 0) * LANES + col
    out = np.where(inside, tbl.reshape(-1)[src], INT32_MIN)
    return out.reshape(idx.shape).astype(np.int32), int(steps.max())


@pytest.mark.parametrize("name", list(SLAB_RANGES))
@pytest.mark.parametrize("rpb", [8, 24, 7233, 7240, 16384])
def test_direct_spans_gather_what_plain_and_the_tool_body_give(rpb, name):
    """The direct path's spans on two blocks (three at rpb 8 and 24): 16
    rows a span, so at rpb 8 a span steps over a block's end and at 24,
    7233 and 7240 some spans start off a block's start; gathering by that
    arithmetic gives subgather_plain and, at the small blocks, the Pallas
    body in interpret mode."""
    lo, hi = SLAB_RANGES[name](rpb)
    rng = np.random.default_rng(rpb + len(name))
    rows = (3 if rpb < 1024 else 2) * rpb
    tbl = _table(7, rows)
    idx = rng.integers(lo, hi, (rows, LANES), dtype=np.int64).astype(np.int32)
    got, steps = _gather_by_spans(tbl, idx, rpb)
    assert steps == (0 if rpb == 16384 else 1)
    assert np.array_equal(got, tools_cuda.subgather_plain(_t(tbl), _t(idx), rpb)[0].numpy())
    if rpb < 1024:
        assert np.array_equal(got, _subgather_pallas(tbl, idx, rpb)[0])


# --- T5: the op mix --------------------------------------------------------------


def _mix_pallas(x, tok, k, rpb=RPB):
    """exp_pack.chain.call's BlockSpecs, interpret mode, k calls chained
    through the token."""
    rows = x.shape[0]
    call = pl.pallas_call(
        JAX_PACK._mix_kernel(x.dtype),
        grid=(rows // rpb,),
        in_specs=[
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        ],
        out_specs=(
            pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((rows, LANES), x.dtype),
            jax.ShapeDtypeStruct((1, 1), jnp.int32),
        ),
        interpret=True,
    )
    t = jnp.asarray(tok)
    for _ in range(k):
        out, t = call(jnp.asarray(x), t)
    return np.asarray(out), np.asarray(t)


def _mix_input(name, seed, full_range):
    """The tool's inputs ([0, 100)) or values over the type's whole range,
    which overflow in the multiply and the add."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(name)
    lo, hi = (info.min, info.max + 1) if full_range else (0, 100)
    return rng.integers(lo, hi, (ROWS, LANES), dtype=np.int64).astype(name)


@pytest.mark.parametrize("name", list(tools_cuda.MIX_DTYPES))
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("full_range", [False, True])
def test_op_mix_equals_tool_body(name, k, full_range):
    x = _mix_input(name, 5 + k, full_range)
    tok = np.full((1, 1), 5, np.int32)
    ref_out, ref_tok = _mix_pallas(x, tok, k)
    got_out, got_tok = tools_cuda.op_mix(_t(x), _t(tok), k, RPB)
    assert got_out.dtype == tools_cuda.MIX_DTYPES[name]
    assert np.array_equal(got_out.numpy(), ref_out)
    assert np.array_equal(got_tok.numpy(), ref_tok) and int(got_tok) == 5 + k * (ROWS // RPB - 1)
    plain = tools_cuda.op_mix_plain(_t(x), _t(tok), k, RPB)
    assert torch.equal(plain[0], got_out) and torch.equal(plain[1], got_tok)


def test_op_mix_rolls_toward_higher_lanes():
    """pltpu.roll(acc, 1, axis=1) hands lane l the value of lane l - 1: a
    row whose only nonzero is at lane 5 changes lanes 5 to 13 (one lane
    per repetition) and no lane below 5."""
    x = np.zeros((RPB, LANES), np.int32)
    x[0, 5] = 1000
    out, _ = tools_cuda.op_mix(_t(x), torch.zeros((1, 1), dtype=torch.int32), 1, RPB)
    zero_row, _ = tools_cuda.op_mix(torch.zeros((RPB, LANES), dtype=torch.int32),
                                    torch.zeros((1, 1), dtype=torch.int32), 1, RPB)
    changed = np.nonzero(out.numpy()[0] != zero_row.numpy()[0])[0]
    assert changed.min() == 5 and changed.max() <= 5 + tools_cuda.MIX_REPS
    assert np.array_equal(out.numpy(), _mix_pallas(x, np.zeros((1, 1), np.int32), 1)[0])


def test_op_mix_refuses_other_types_and_ragged_rows():
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32, int16 or int8"):
        tools_cuda.op_mix(torch.zeros((8, LANES), dtype=torch.int64), tok, 1, RPB)
    with pytest.raises(ValueError, match="rows_per_block"):
        tools_cuda.op_mix(torch.zeros((12, LANES), dtype=torch.int8), tok, 1, RPB)
    with pytest.raises(ValueError, match="k >= 1"):
        tools_cuda.op_mix(torch.zeros((8, LANES), dtype=torch.int8), tok, 0, RPB)


def test_wrappers_count_no_launch_on_the_cpu():
    tools_cuda.reset_launches()
    tbl = _t(_table(6))
    tools_cuda.subgather(tbl, torch.zeros_like(tbl), RPB)
    tools_cuda.op_mix(tbl, torch.zeros((1, 1), dtype=torch.int32), 2, RPB)
    assert {"subgather", "op_mix_int32", "op_mix_int16", "op_mix_int8"} <= set(
        tools_cuda.launches)
    assert all(v == 0 for v in tools_cuda.launches.values())


def test_op_mix_bound_counts_operations():
    """64 operations per element at 2 Mi elements on 132 x 128 lanes issued
    per clock at 1980 MHz: about 4.0 us at one element a 32-bit lane, under
    the int32 bytes' 5 us. int16 and int8 carry two and four elements a lane:
    2.0 and 1.0 us, under their bytes' 2.5 and 1.3 us, so every type is
    bound by its bytes."""
    ops = 16384 * LANES * exp_pack.OPS_PER_REP * tools_cuda.MIX_REPS
    from blt_tpu_torch.tools import _common

    assert ops == 134_217_728
    assert exp_pack.LANE_ELEMENTS == {"int32": 1, "int16": 2, "int8": 4}
    assert _common.ops_bound_ms(ops, 1980) == pytest.approx(0.004012, rel=1e-3)
    for name, bytes_ms, ops_ms in (("int32", 0.005008, 0.004012), ("int16", 0.002504, 0.002006),
                                   ("int8", 0.001252, 0.001003)):
        size = np.dtype(name).itemsize
        assert _common.bound_ms(2 * 16384 * LANES * size + 8) == pytest.approx(bytes_ms, rel=1e-3)
        assert _common.ops_bound_ms(ops // exp_pack.LANE_ELEMENTS[name], 1980) == pytest.approx(
            ops_ms, rel=1e-3)
        assert bytes_ms > ops_ms


# --- T5's packed words: a mirror of op_mix.cu's int16 and int8 steps -------------

OP_MIX_CU = REPO / "blt_tpu_torch" / "csrc" / "op_mix.cu"
PACKED = {"int16": "Mix16", "int8": "Mix8"}
U32 = np.uint32


def _mix_constants(text=None):
    """Each packed struct's constants as op_mix.cu defines them, by struct."""
    text = OP_MIX_CU.read_text() if text is None else text
    out = {}
    for struct, body in re.findall(r"struct (Mix\d+) \{(.*?)\n\};", text, re.S):
        out[struct] = {
            name: int(eval(re.sub(r"(?<=[0-9A-Fa-f])u\b", "", expr), {"__builtins__": {}}))
            for name, expr in re.findall(r"static constexpr (?:int|uint32_t) (k\w+) = ([^;]+);",
                                         body)}
    return out


MIX_K = _mix_constants()


def _prmt(a, b, sel):
    """PTX ``prmt.b32`` in its default mode: byte i of the result is byte
    ``n & 7`` of (b:a), n the selector's nibble i, or that byte's sign over
    8 bits where n & 8."""
    src = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    out = np.zeros(np.shape(src), np.uint64)
    for i in range(4):
        n = (sel >> 4 * i) & 0xF
        byte = (src >> np.uint64(8 * (n & 7))) & np.uint64(0xFF)
        if n & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= byte << np.uint64(8 * i)
    return out.astype(U32)


def _max_s16x2(a, b):
    """PTX ``max.s16x2``: the signed max of each halfword."""
    a, b = np.ascontiguousarray(a, U32), np.ascontiguousarray(b, U32)
    return np.maximum(a.view(np.int16), b.view(np.int16)).view(U32)


def _add_16x2(a, b):
    """PTX ``add.s16x2``: each halfword's sum, wrapping."""
    a = np.ascontiguousarray(a, U32)
    b = np.ascontiguousarray(np.broadcast_to(np.asarray(b, U32), a.shape))
    return (a.view(np.int16) + b.view(np.int16)).view(U32)


def _step16(w, prev, m, K):
    """Mix16::step on uint32 words."""
    y = (((w & U32(K["kMod512"])) * U32(31)) >> U32(3)) & U32(K["kLow6"])
    differ = _prmt((y ^ (w & U32(K["kLow6"]))) + U32(K["kDiffBias"]), 0, K["kSpreadSel"])
    s = (y & differ) | (_prmt(prev, w, K["kRollSel"]) & ~differ)
    return _add_16x2(_max_s16x2(s, m), K["kOne"])


def _step8(w, prev, m, K):
    """Mix8::step on uint32 words."""
    mul = U32(K["kMul"])
    f = _prmt((w & U32(K["kEven"])) * mul, _prmt(w, 0, K["kOddSel"]) * mul, K["kFieldSel"])
    y = (f & U32(K["kLow5"])) + U32(2) * (f & U32(K["kBit4"]))
    differ = _prmt(((y ^ w) & U32(K["kLow6"])) + U32(K["kDiffBias"]), 0, K["kSpreadSel"])
    s = (y & differ) | (_prmt(prev, w, K["kRollSel"]) & ~differ)
    one = K["kOne"]
    return _prmt(_add_16x2(_max_s16x2(s << U32(8), m << U32(8)), one),
                 _add_16x2(_max_s16x2(s, m), one), K["kJoinSel"])


def _mix_packed_mirror(x, K=None):
    """op_mix_packed_kernel on the host: each row split over kRowThreads
    threads of one 16-byte vector (4 words), MIX_REPS repetitions, the
    first word's roll from the thread before (the shuffle, cyclic in the
    row), the row's first word entering the max through kFirstKeep and
    kFirstMin. x: int16 or int8 (rows, 128); returns the output."""
    K = MIX_K[PACKED[x.dtype.name]] if K is None else K
    tpr = K["kRowThreads"]
    acc = np.ascontiguousarray(x).view(U32).reshape(x.shape[0], tpr, 4).copy()
    first = np.arange(tpr) == 0
    keep = np.where(first, U32(K["kFirstKeep"]), U32(0xFFFFFFFF))
    low = np.where(first, U32(K["kFirstMin"]), U32(0))
    step = _step16 if x.dtype == np.int16 else _step8
    for _ in range(tools_cuda.MIX_REPS):
        prev = np.roll(acc[:, :, 3], 1, axis=1)
        nxt = np.empty_like(acc)
        for j in range(4):
            m = acc[:, :, j] if j else (acc[:, :, 0] & keep) | low
            nxt[:, :, j] = step(acc[:, :, j], prev, m, K)
            prev = acc[:, :, j]
        acc = nxt
    return acc.reshape(x.shape[0], -1).view(x.dtype).reshape(x.shape)


def _every_value(name, rows_per_copy):
    """Every value of the type once, in random order, as rows of 128."""
    info = np.iinfo(name)
    v = np.random.default_rng(info.bits).permutation(np.arange(info.min, info.max + 1))
    reps = -(-rows_per_copy * LANES // v.size)
    return np.tile(v, reps).astype(name).reshape(-1, LANES)


def test_mix_constants_fit_a_row():
    """Each packed struct's threads a row hold its 128 lanes in 16-byte
    vectors."""
    assert set(MIX_K) == {"Mix16", "Mix8"}
    for name, struct in PACKED.items():
        assert MIX_K[struct]["kRowThreads"] * 16 == LANES * np.dtype(name).itemsize


@pytest.mark.parametrize("name", list(PACKED))
@pytest.mark.parametrize("k", [1, 3])
def test_packed_mirror_over_every_value(name, k):
    """Every value of the type at every lane position class, against the
    Pallas body (one grid step) and op_mix_plain."""
    x = _every_value(name, 8)
    rpb = x.shape[0]
    tok = np.full((1, 1), 2, np.int32)
    got = _mix_packed_mirror(x)
    assert np.array_equal(got, _mix_pallas(x, tok, k, rpb)[0])
    assert np.array_equal(got, tools_cuda.op_mix_plain(_t(x), _t(tok), k, rpb)[0].numpy())


@pytest.mark.parametrize("name", list(PACKED))
@pytest.mark.parametrize("k", [1, 3])
def test_packed_mirror_edge_rows(name, k):
    """exp_pack.edge_rows: the type's min, max, -1 and 0 at lanes 0, 1, 2, 127
    and beside every word and vector boundary, rows whose select fires;
    against the Pallas body and op_mix_plain."""
    x = exp_pack.edge_rows(name, 48, seed=k)
    tok = np.zeros((1, 1), np.int32)
    got = _mix_packed_mirror(x)
    ref_out, ref_tok = _mix_pallas(x, tok, k)
    assert np.array_equal(got, ref_out) and ref_tok.item() == k * (48 // RPB - 1)
    assert np.array_equal(got, tools_cuda.op_mix_plain(_t(x), _t(tok), k, RPB)[0].numpy())


def test_edge_rows_reach_each_case():
    """The edge rows hold each edge value at lanes 0, 1, 2 and 127, and
    rows whose every lane fires the first repetition's select."""
    for name in tools_cuda.MIX_DTYPES:
        info = np.iinfo(name)
        x = exp_pack.edge_rows(name, 40).astype(np.int64)
        for e in (info.min, info.max, -1, 0):
            assert all((x[:, lane] == e).any() for lane in (0, 1, 2, 127))
            assert (x == e).all(axis=1).any()
        fires = exp_pack._mix_y(x, info.bits) == (x & 0x3F)
        assert fires.all(axis=1).sum() >= 4
    with pytest.raises(ValueError, match="edge rows"):
        exp_pack.edge_rows("int8", 39)


# (constant, a wrong value): each breaks one step of the mirror
MUTANTS = {
    "Mix16": {"kMod512": 0xFFFFFFFF, "kLow6": 0x3F3F3F3F, "kDiffBias": 0x7FFF8000,
              "kSpreadSel": 0x9999, "kRollSel": 0x7654, "kOne": 0x00020001,
              "kFirstMin": 0x7FFF7FFF},
    "Mix8": {"kEven": 0xFFFFFFFF, "kOddSel": 0x4240, "kMul": 31 * 16, "kFieldSel": 0x3715,
             "kLow5": 0x1F1F1F3F, "kBit4": 0x10101000, "kLow6": 0x3F3F3F7F,
             "kDiffBias": 0x7F7F7F80, "kSpreadSel": 0x8888, "kRollSel": 0x7654,
             "kJoinSel": 0x3715, "kOne": 0x01000101, "kFirstKeep": 0, "kFirstMin": 0x00007F7F},
}


@pytest.mark.parametrize("struct,const", [(s, c) for s, m in MUTANTS.items() for c in m])
def test_packed_mirror_fails_on_a_wrong_constant(struct, const):
    """The edge rows tell a wrong mask or selector from the right one."""
    name = next(n for n, s in PACKED.items() if s == struct)
    x = exp_pack.edge_rows(name, 48)
    plain = tools_cuda.op_mix_plain(_t(x), torch.zeros((1, 1), dtype=torch.int32), 1, RPB)[0]
    assert np.array_equal(_mix_packed_mirror(x), plain.numpy())
    bad = dict(MIX_K[struct], **{const: MUTANTS[struct][const]})
    assert not np.array_equal(_mix_packed_mirror(x, bad), plain.numpy())


# --- the entry points, as processes ------------------------------------------------


def _run_tool(tool):
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
        assert row["exact"] is True and row["graph"] is None and row["k"] in (2, 4)
        assert row["eager"]["ms_per_launch"]["n"] == 5 and row["bound_ms"] > 0
        assert row["bound_by"] in ("bytes", "operations")
    return out


def test_exp_pack_runs_on_the_cpu():
    out = _run_tool("exp_pack")
    assert [(r["dtype"], r["bound_by"]) for r in out["rows"]] == [
        ("int32", "bytes"), ("int16", "bytes"), ("int8", "bytes")]
    for r in out["rows"]:
        lanes = exp_pack.LANE_ELEMENTS[r["dtype"]]
        assert r["ops"] * lanes == 2048 * LANES * exp_pack.OPS_PER_REP * tools_cuda.MIX_REPS
        assert r["ops_bound_32_ms"] == pytest.approx(lanes * r["ops_bound_ms"])
        assert r["bound_ms"] == r["bytes_bound_ms"] > r["ops_bound_ms"]


def test_exp_parts_subgather_rows():
    rows = exp_parts.subgather_rows(torch.device("cpu"), 1 << 20, k=1)
    assert [r["idx_range"] for r in rows] == list(exp_parts.SUBGATHER_RANGES)
    assert all(r["exact"] and r["library_ms"] > 0 for r in rows)
    # indices below 8 reach 8 of each block's 1024 rows of table
    assert rows[1]["bound_ms"] == pytest.approx(((2 + 8 / 1024) * (1 << 20) + 4) / 3.35e12 * 1e3)
    assert rows[0]["bound_ms"] < 3 * (1 << 20) / 3.35e12 * 1e3


def test_subgather_table_words_read():
    idx = np.zeros((2 * RPB, LANES), np.int32)
    idx[0, :3] = [1, -1, 99]  # rows 1 and 7 of block 0; 99 fills
    words = exp_parts.table_words_read(_t(idx), RPB)
    # row 0 of each block in every column but 0..2 of row 0, which the
    # other rows' zeros reach too, plus rows 1 and 7 in columns 0 and 1
    assert words == 2 * LANES + 2


@pytest.mark.parametrize("tool", ["exp_parts", "exp_pack", "exp_mp_ablate", "exp_scan",
                                  "exp_gap"])
def test_tools_without_a_card_exit_naming_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the suite's other workers share the cores
    r = subprocess.run([sys.executable, "-m", f"blt_tpu_torch.tools.{tool}", "--k", "1"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode != 0 and "CUDA" in r.stderr
