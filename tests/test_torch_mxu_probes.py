"""The one-hot lookup T14 and the 16-bit probes T3 and T11 of the torch port
against the JAX tools, on the CPU.

T14 (``tools_cuda.pmxu``, ``blt_tpu_torch.tools.exp_gather``'s ``pmxu_i8``
and ``pmxu_bf16`` rows) against ``tools/exp_gather.py::make_pmxu(...,
interpret=True)`` in int8 and bf16, at 8 and 16 rows and tiles of 256 and
512 positions, at 8 rows and tile 16, and at 5 rows and tile 80, once on p
inside and outside ``[0, 65536)`` (outside, the one-hot row is all zero:
32896 in int8, 0 in bf16) and chained 3 times; the library rows
``xla_take``, ``mxu_bf16`` and ``mxu_int8`` against ``make_xla_take``,
``make_mxu_bf16`` and ``make_mxu_int8``. The planes' shared-memory image
(``tools_cuda.mxu_image``), read back through the kernel's descriptor
offsets and swizzle written out here; the build's readers of ptxas's
report and of the SASS (``_cuda_build.kernel_resources``, ``sass_counts``)
on stand-in outputs. T3
(``tools_cuda.probe16``, ``blt_tpu_torch.tools.exp_16bit``) against
``tools/exp_16bit.py``'s six bodies in ``pl.pallas_call(...,
interpret=True)`` with the tool's BlockSpecs at its 512 rows, on ``arange %
97`` and on random |x| < 2**30 with negatives. T11
(``blt_tpu_torch.tools.canary_16bit``) against ``run_canary()`` itself, its
``pallas_call`` run in interpret mode. On the CPU the port's wrappers run
their plain PyTorch versions. Every comparison is exact (tolerance 0);
inputs come from numpy ``default_rng(seed)``.
"""

import functools
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

from blt_tpu.utils import compcache
from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import canary_16bit, exp_16bit, exp_gather

REPO = Path(__file__).resolve().parent.parent
LANES = 128
INT32 = np.iinfo(np.int32)


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


JAX_GATHER = _jax_tool("exp_gather")
JAX_16BIT = _jax_tool("exp_16bit")
JAX_CANARY = _jax_tool("canary_16bit")
VAL16 = exp_gather.build_table()[0]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _p(seed, rows, lo=0, hi=65536):
    """p of the tool's domain, and with ``lo, hi`` another range; the first
    row's first lanes hold the domain's edges and values past it."""
    p = np.random.default_rng(seed).integers(lo, hi, (rows, LANES), dtype=np.int64).astype(np.int32)
    p[0, :9] = [0, 255, 256, 65535, -1, 65536, 131071, INT32.min, INT32.max]
    return p


# --- T14 -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(tools_cuda.MXU_DTYPES))
@pytest.mark.parametrize("rows,tile", [(8, 256), (8, 512), (16, 256), (16, 512), (8, 16),
                                       (5, 80)])
def test_pmxu_equals_tool_kernel(dtype, rows, tile):
    """Once on p inside and outside the domain, and chained 3 times."""
    once, chained = JAX_GATHER.make_pmxu(VAL16, rows, 3, dtype, tile=tile, interpret=True)
    planes = tools_cuda.mxu_planes(VAL16, dtype)
    p = _p(70 + rows, rows)
    want = np.asarray(once(jnp.asarray(p)))
    outside = 32896 if dtype == "int8" else 0
    assert want[0, :9].tolist() == [VAL16[0], VAL16[255], VAL16[256], VAL16[65535]] + [outside] * 5
    assert np.array_equal(want[:, 9:], VAL16[p[:, 9:]].astype(np.int32))
    assert np.array_equal(tools_cuda.pmxu(dtype, planes, _t(p), tile=tile).numpy(), want)
    assert np.array_equal(tools_cuda.pmxu_plain(dtype, planes, _t(p), tile=tile).numpy(), want)
    want_k = np.asarray(chained(jnp.asarray(p)))
    assert np.array_equal(exp_gather.chained_mxu(dtype, planes, _t(p), 3, tile).numpy(), want_k)
    assert np.array_equal(
        exp_gather.chained_mxu(dtype, planes, _t(p), 3, tile, plain=True).numpy(), want_k)


def _kernel_offset(esize, n, k, j):
    """Where ``onehot_mma.cu`` reads byte j of planes[k][n] (numpy arrays),
    as a byte offset into the image: the wgmma descriptor of n's plane (lo
    n < 256, hi past) and of the k-step holding K byte k * esize + j starts
    at the plane (64 KB of s8, 128 KB of bf16) plus 32 KB per 128-byte K
    slice plus 32 bytes per k-step within it; the canonical K-major layout
    puts a column's 8-column group SBO = 1024 bytes on, the column 128
    bytes on within it, its K bytes in order; then the 128-byte swizzle
    xors address bits 4..6 with bits 7..9 (the image lies 1024-aligned in
    shared memory)."""
    plane, col = np.divmod(n, 256)
    step, within = np.divmod(k * esize + j, 32)
    start = plane * (256 * 256 * esize) + (step >> 2) * (256 * 128) + (step & 3) * 32
    addr = start + (col // 8) * 1024 + (col % 8) * 128 + within
    return addr ^ (((addr >> 7) & 7) << 4)


@pytest.mark.parametrize("dtype", list(tools_cuda.MXU_DTYPES))
def test_mxu_image_reads_back_planes_by_the_kernels_address_formula(dtype):
    planes = tools_cuda.mxu_planes(VAL16, dtype)
    esize = planes.element_size()
    image = tools_cuda.mxu_image(planes).numpy()
    assert image.dtype == np.uint8 and image.shape == (256 * 512 * esize,)
    raw = planes.view(torch.uint8).numpy().reshape(256, 512, esize)
    k, n, j = np.meshgrid(np.arange(256), np.arange(512), np.arange(esize), indexing="ij")
    offsets = _kernel_offset(esize, n, k, j)
    assert np.array_equal(image[offsets], raw)
    # every byte of the image is some (k, n) byte, once
    assert np.array_equal(np.sort(offsets.reshape(-1)), np.arange(image.size))


def test_mxu_image_is_laid_out_once_per_planes_tensor():
    planes = tools_cuda.mxu_planes(VAL16, "int8")
    first = tools_cuda._image_of(planes)
    assert tools_cuda._image_of(planes) is first
    other = planes.clone()
    assert tools_cuda._image_of(other) is not first
    planes[0, 0] += 1  # written in place: a new image
    again = tools_cuda._image_of(planes)
    assert again is not first and not torch.equal(again, first)
    assert torch.equal(again, tools_cuda.mxu_image(planes))


def test_kernel_resources_read_ptxas_report(monkeypatch):
    from blt_tpu_torch.ops import _cuda_build

    report = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z11pmxu_kernelILi0EEvPKh' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z11pmxu_kernelILi0EEvPKh\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]\n")
    monkeypatch.setitem(_cuda_build.ptxas_log, "onehot_mma", report)
    assert _cuda_build.kernel_resources("onehot_mma") == {
        "_Z11pmxu_kernelILi0EEvPKh": {"registers": 168, "spill_stores": 8, "spill_loads": 4}}
    assert _cuda_build.kernel_resources("no_such_source") == {}


def test_sass_counts_read_cuobjdump(monkeypatch, tmp_path):
    """A stand-in cuobjdump beside a stand-in nvcc: the opcodes asked for
    (the warpgroup products; the bulk copies) are counted in the kernels
    whose names match, other kernels left out; no cuobjdump gives None."""
    from blt_tpu_torch.ops import _cuda_build

    sass = ["\t\tFunction : _Z11pmxu_kernelILi0E",
            "  /*0010*/  WARPGROUP.ARRIVE ;",
            "  /*0020*/  IGMMA.64x256x32.S8.S8 R24, R152, gdesc[UR8], RZ, !UPT ;",
            "  /*0030*/  IGMMA.64x256x32.S8.S8 R24, R156, gdesc[UR4], R24, gsb0 ;",
            "\t\tFunction : _Z5widen",
            "  /*0010*/  HGMMA.64x8x16.F32.BF16 R0, R4, gdesc[UR4], RZ ;",
            "\t\tFunction : _Z16copy_ring_kernel",
            "  /*0010*/  UBLKCP.S.G [UR8], [UR4], UR6 ;",
            "  /*0020*/  SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR9], R3 ;",
            "  /*0030*/  UBLKCP.G.S [UR10], [UR8], UR6 ;"]
    tool = tmp_path / "cuobjdump"
    tool.write_text("#!/bin/sh\nprintf '%s\\n' " + " ".join(f"'{line}'" for line in sass) + "\n")
    tool.chmod(0o755)
    monkeypatch.setattr(_cuda_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(_cuda_build, "build", lambda: tmp_path / "lib.so")
    assert _cuda_build.sass_counts("pmxu_kernel", ("HGMMA", "IGMMA")) == {
        "_Z11pmxu_kernelILi0E": {"HGMMA": 0, "IGMMA": 2}}
    assert _cuda_build.sass_counts("copy_ring", ("UBLKCP",)) == {
        "_Z16copy_ring_kernel": {"UBLKCP": 2}}
    tool.unlink()
    assert _cuda_build.sass_counts("pmxu_kernel", ("HGMMA", "IGMMA")) is None


@pytest.mark.parametrize("dtype", list(tools_cuda.MXU_DTYPES))
def test_pmxu_over_the_whole_int32_range(dtype):
    """A link fed any int32 takes (p + (c & 1)) & 0xFFFF, as the tool's."""
    rows = 8
    _, chained = JAX_GATHER.make_pmxu(VAL16, rows, 3, dtype, tile=512, interpret=True)
    planes = tools_cuda.mxu_planes(VAL16, dtype)
    p = _p(80, rows, INT32.min, INT32.max)
    assert np.array_equal(exp_gather.chained_mxu(dtype, planes, _t(p), 3, 512).numpy(),
                          np.asarray(chained(jnp.asarray(p))))
    c = _t(p[::-1].copy())
    assert torch.equal(tools_cuda.pmxu(dtype, planes, _t(p), c),
                       tools_cuda.pmxu(dtype, planes, (_t(p) + (c & 1)) & 0xFFFF))


@pytest.mark.parametrize("name,make", [("xla_take", "make_xla_take"),
                                       ("mxu_bf16", "make_mxu_bf16"),
                                       ("mxu_int8", "make_mxu_int8")])
def test_library_rows_equal_tool_xla_rows(name, make):
    rows = 16
    once, chained = getattr(JAX_GATHER, make)(VAL16, rows, 3)
    table = (_t(VAL16.astype(np.int32)) if name == "xla_take"
             else tools_cuda.mxu_planes(VAL16, exp_gather.MXU_DTYPE[name]))
    # torch.take raises on an index past the table, jnp.take fills: the
    # domain alone for xla_take
    p = _p(90, rows) if name != "xla_take" else _p(90, rows)[1:]
    want = np.asarray(once(jnp.asarray(p)))
    assert np.array_equal(exp_gather.library_link(name, table, _t(p)).numpy(), want)
    assert np.array_equal(exp_gather.library_chain(name, table, _t(p), 3).numpy(),
                          np.asarray(chained(jnp.asarray(p))))


def test_exp_gather_rows_are_the_originals():
    out = exp_gather.measure(torch.device("cpu"), 16 * 4 * LANES, 2,
                             only=("pmxu_i8", "pmxu_bf16", "xla_take", "mxu_bf16", "mxu_int8"),
                             tile=256)
    assert out["exact"] is True and out["tile"] == 256
    rows = {r["name"]: r for r in out["rows"]}
    assert list(rows) == ["pmxu_i8", "pmxu_bf16", "xla_take", "mxu_bf16", "mxu_int8"]
    for name in tools_cuda.MXU_LOOKUPS:
        assert rows[name]["kernel"] == "T14" and rows[name]["route"] == "cuda"
        assert rows[name]["bound_by"] == "operations" and rows[name]["library_ms"] > 0
    for name in exp_gather.LIBRARY:
        assert rows[name]["route"] == "torch" and rows[name]["kernel"] is None
    # 2 * 256 * 512 operations per position over the dense peaks
    n = 16 * LANES
    assert rows["pmxu_bf16"]["bound_ms"] == pytest.approx(n * 262144 / 989e12 * 1e3)
    assert rows["pmxu_i8"]["bound_ms"] == pytest.approx(n * 262144 / 1979e12 * 1e3)
    assert rows["xla_take"]["bound_by"] == "bytes"


def test_pmxu_refuses_what_its_kernel_does_not_take():
    planes = tools_cuda.mxu_planes(VAL16, "int8")
    p = _t(_p(91, 8))
    for tile in (0, 8, 24, 3072):  # not a positive multiple of 16 that divides 1024
        with pytest.raises(ValueError, match="multiple of 16 that divides"):
            tools_cuda.pmxu("int8", planes, p, tile=tile)
        with pytest.raises(ValueError, match="multiple of 16 that divides"):
            exp_gather.measure(torch.device("cpu"), 8 * 4 * LANES, 1, only=("pmxu_i8",),
                               tile=tile)
    with pytest.raises(ValueError, match="unknown dtype"):
        tools_cuda.pmxu("fp8", planes, p)
    with pytest.raises(ValueError, match="unknown dtype"):
        tools_cuda.mxu_planes(VAL16, "int4")
    with pytest.raises(ValueError, match="planes"):
        tools_cuda.pmxu("bf16", planes, p)
    with pytest.raises(ValueError, match="planes"):
        tools_cuda.pmxu("int8", planes[:, :256], p)
    with pytest.raises(ValueError, match="int32"):
        tools_cuda.pmxu_plain("int8", planes, p.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        tools_cuda.pmxu("int8", planes, p.reshape(-1, 1))
    with pytest.raises(ValueError, match="previous output"):
        tools_cuda.pmxu("int8", planes, p, p[:4])


# --- T3 --------------------------------------------------------------------------------

T3_BODIES = {"bf16_roll": "k_bf16_roll", "bf16_max": "k_bf16_max",
             "bf16_select": "k_bf16_select", "bf16_rowroll": "k_bf16_rowroll",
             "i16_roll": "k_i16_roll", "bf16_scan7": "k_bf16_scan"}


def _x(which, rows=JAX_16BIT.R):
    if which == "arange":
        return exp_16bit.original_x(rows).numpy()
    x = np.random.default_rng(100).integers(-(2**30) + 1, 2**30, (rows, LANES),
                                            dtype=np.int64).astype(np.int32)
    # int -> f32 -> bf16 rounds twice; a direct rounding differs on these
    x[0, :4] = [2**25 + 2**17 + 1, -(2**25 + 2**17 + 1), 2**30 - 1, -(2**30) + 1]
    x[-1, :6] = [-1, -2, -3, 1, 2, 3]  # bf16_max picks b / 2 for b < 0, truncated
    return x


def _run_tool_body(body, x):
    """exp_16bit.run's call: one block, the whole array in VMEM."""
    return np.asarray(pl.pallas_call(
        getattr(JAX_16BIT, body),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True,
    )(jnp.asarray(x)))


@pytest.mark.parametrize("which", ["arange", "random"])
@pytest.mark.parametrize("name", list(T3_BODIES))
def test_probe_equals_tool_body(name, which):
    x = _x(which)
    want = _run_tool_body(T3_BODIES[name], x)
    assert np.array_equal(tools_cuda.probe16(f"probe16_{name}", _t(x)).numpy(), want)


def test_bf16_cast_agrees_with_xla_below_2_30_only():
    """The plain versions' domain: past int32, XLA saturates bf16 -> int32
    where a torch cast wraps."""
    x = np.array([2**30 - 1, -(2**30) + 1, INT32.max], np.int32)
    jax_back = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.int32))
    torch_back = _t(x).to(torch.bfloat16).to(torch.int32).numpy()
    assert jax_back[:2].tolist() == torch_back[:2].tolist() == [2**30, -(2**30)]
    assert jax_back[2] == INT32.max and torch_back[2] == INT32.min


@pytest.mark.parametrize("rows", [1, 8, 13, 513])
def test_probes_take_any_row_count(rows):
    """The plain versions at the card's other row counts equal their
    definitions written in numpy."""
    x = _x("random", rows)
    lane = np.arange(LANES)
    f32 = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # bf16(x), exact in f32
    got = {p.split("_", 1)[1]: tools_cuda.probe16(p, _t(x)).numpy() for p in tools_cuda.PROBES16}
    assert np.array_equal(got["bf16_roll"], np.roll(f32, 1, 1).astype(np.int32))
    assert np.array_equal(got["bf16_rowroll"], np.roll(f32, 1, 0).astype(np.int32))
    assert np.array_equal(got["bf16_select"], np.where(lane >= 5, f32, -1).astype(np.int32))
    assert np.array_equal(got["bf16_max"], np.trunc(np.maximum(f32, f32 / 2)).astype(np.int32))
    assert np.array_equal(got["i16_roll"], np.roll(x.astype(np.int16), 1, 1).astype(np.int32))
    scan = np.maximum.accumulate(np.where((x & 3) == 0, -1, lane), axis=1)
    assert np.array_equal(got["bf16_scan7"], scan)
    assert np.array_equal(got["strided_sublane"], x[0::2])
    assert got["strided_sublane"].shape == ((rows + 1) // 2, LANES)


def _probe_constant(name: str) -> int:
    text = (REPO / "blt_tpu_torch" / "csrc" / "probe16.cu").read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text)[1]
    return int(eval(expr, {}, {"kThreads": 256, "kRowsPerWarp": 4}))  # noqa: S307 - our sources


def _probe_grid(out_rows: int, sms: int = 132):
    """probe16.cu's grid_of: (CTAs, threads a CTA, rows a warp)."""
    threads, per_warp = _probe_constant("kThreads"), _probe_constant("kRowsPerWarp")
    per_cta, fill = _probe_constant("kRowsPerCta"), _probe_constant("kFillCtas")
    if out_rows >= fill * sms * per_cta:
        return -(-out_rows // per_cta), threads, per_warp
    warps = min(-(-out_rows // sms), threads // 32)
    return -(-out_rows // warps), 32 * warps, 1


def test_probe_grid_constants_are_the_kernels():
    assert [_probe_constant(k) for k in ("kThreads", "kRowsPerWarp", "kRowsPerCta",
                                         "kFillCtas")] == [256, 4, 32, 4]
    assert _probe_grid(131072) == (4096, 256, 4)
    assert _probe_grid(512) == (128, 128, 1) and _probe_grid(8) == (8, 32, 1)
    text = (REPO / "blt_tpu_torch" / "csrc" / "probe16.cu").read_text()
    assert "__shared__" not in text and "__syncthreads" not in text


@pytest.mark.parametrize("rows", [1, 13, 513, 16896])
def test_probe_grid_takes_each_row_once(rows):
    """probe16.cu's grid mirrored: a warp a row, rows_per_warp rows a warp;
    every output row is written by one warp, every read lies inside x (row
    r - 1 for bf16_rowroll, 2r for strided_sublane), and the wrapper takes
    the row count. 16896 rows is the first that fills 132 SMs with 4 CTAs of
    32 rows."""
    x = _x("random", rows)
    for probe in tools_cuda.PROBES16:
        out_rows = (rows + 1) // 2 if probe == "canary_strided_sublane" else rows
        ctas, threads, per_warp = _probe_grid(out_rows)
        warps = np.arange(ctas * threads // 32)
        r = (warps[:, None] * per_warp + np.arange(per_warp)).reshape(-1)
        r = r[r < out_rows]
        assert np.array_equal(np.sort(r), np.arange(out_rows)), probe
        src = {"canary_strided_sublane": 2 * r,
               "probe16_bf16_rowroll": np.where(r == 0, rows - 1, r - 1)}.get(probe, r)
        assert src.min() >= 0 and src.max() < rows, probe
        # the rows the warps read, through the elementwise body, are the probe's result
        if probe in ("canary_strided_sublane", "probe16_bf16_rowroll"):
            body = _t(x[src]).to(torch.bfloat16).to(torch.int32) if "rowroll" in probe \
                else _t(x[src])
            assert torch.equal(tools_cuda.probe16(probe, _t(x))[r], body), probe


def test_exp_16bit_runs_the_originals_probes():
    out = exp_16bit.measure(torch.device("cpu"), 1024 * 4 * LANES, 2)
    assert out["exact"] is True and out["x_rows"] == [512, 1024]
    assert list(out["results"]) == list(T3_BODIES)
    assert [(r["name"], r["x_rows"]) for r in out["rows"]] == [
        (n, rows) for rows in (512, 1024) for n in T3_BODIES]
    for r in out["rows"]:
        assert r["kernel"] == "T3" and r["library_ms"] is None and r["bound_by"] == "bytes"
        assert r["bound_ms"] == pytest.approx(8 * r["x_rows"] * LANES / 3.35e12 * 1e3)


# --- T11 -------------------------------------------------------------------------------


def test_canary_equals_the_tools_own_run(monkeypatch):
    """run_canary() with its pallas_call in interpret mode: both verdicts
    hold, and its two kernels' outputs equal the port's."""
    captured = []
    real = pl.pallas_call

    def interpreted(*args, **kwargs):
        call = functools.partial(real, interpret=True)(*args, **kwargs)

        def run(*xs):
            out = call(*xs)
            captured.append(np.asarray(out))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    verdict = JAX_CANARY.run_canary()
    assert verdict["i16_roll_ok"] and verdict["strided_sublane_ok"], verdict
    assert verdict["headroom_unblocked"] is True
    x = _t(exp_16bit.original_x(JAX_CANARY.R).numpy())
    assert len(captured) == 2
    assert np.array_equal(tools_cuda.probe16("canary_i16_roll", x).numpy(), captured[0])
    assert np.array_equal(tools_cuda.probe16("canary_strided_sublane", x).numpy(), captured[1])
    out = canary_16bit.measure(torch.device("cpu"), k=2)
    assert {k: out[k] for k in verdict if k != "backend"} == {
        k: v for k, v in verdict.items() if k != "backend"}
    assert out["backend"] == "cpu" and out["x_rows"] == JAX_CANARY.R
    strided = out["rows"][1]
    assert strided["name"] == "strided_sublane" and strided["library_ms"] > 0


def test_probe16_refuses_what_its_kernel_does_not_take():
    x = _t(_x("arange", 8))
    with pytest.raises(ValueError, match="unknown probe"):
        tools_cuda.probe16("bf16_roll", x)  # the name carries its tool
    with pytest.raises(ValueError, match="int32"):
        tools_cuda.probe16("probe16_bf16_max", x.to(torch.int16))
    with pytest.raises(ValueError, match="int32"):
        tools_cuda.probe16("probe16_bf16_max", x.reshape(-1))
    with pytest.raises(ValueError, match="int32"):
        tools_cuda.probe16("canary_i16_roll", x[:0])


def test_wrappers_count_no_launch_on_the_cpu():
    tools_cuda.reset_launches()
    planes = tools_cuda.mxu_planes(VAL16, "bf16")
    exp_gather.chained_mxu("bf16", planes, _t(_p(92, 8)), 2)
    for probe in tools_cuda.PROBES16:
        tools_cuda.probe16(probe, _t(_x("arange", 8)))
    assert all(v == 0 for v in tools_cuda.launches.values())


# --- the entry points, as processes ------------------------------------------------------


def _run_tool(tool, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the suite's other workers share the cores
    return subprocess.run([sys.executable, "-m", f"blt_tpu_torch.tools.{tool}", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


@pytest.mark.parametrize("tool,args", [("exp_16bit", ["--size-mib", "1", "--k", "2"]),
                                       ("canary_16bit", ["--k", "2"])])
def test_entry_point_runs_on_the_cpu(tool, args):
    r = _run_tool(tool, "--device", "cpu", *args)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["tool"] == tool and out["exact"] is True and out["device"] == {"type": "cpu"}
    for row in out["rows"]:
        assert row["exact"] is True and row["graph"] is None and row["bound_ms"] > 0
        assert row["eager"]["ms_per_launch"]["n"] == 5
    if tool == "canary_16bit":
        assert {"backend", "i16_roll_ok", "i16_roll_err", "strided_sublane_ok",
                "strided_sublane_err", "headroom_unblocked"} <= set(out)
        assert out["headroom_unblocked"] is True and out["i16_roll_err"] == ""
    else:
        assert set(out["results"]) == set(T3_BODIES) and all(out["results"].values())


@pytest.mark.parametrize("tool", ["exp_16bit", "canary_16bit"])
def test_entry_point_without_a_card_names_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run_tool(tool)
    assert r.returncode != 0 and "CUDA" in r.stderr
