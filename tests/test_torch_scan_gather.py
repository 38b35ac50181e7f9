"""The mask scan T12 and the lookup designs T13 of the torch port against the
JAX tools, on the CPU.

T12 (``blt_tpu_torch.tools.exp_bf16scan``, ``tools_cuda.mask_scan``) against
``tools/exp_bf16scan.py``'s ``_scan_i32_kernel`` and ``_scan_bf16_kernel``,
and T13 (``blt_tpu_torch.tools.exp_gather``, ``tools_cuda.lookup``) against
``tools/exp_gather.py``'s five ``make_pallas`` bodies, each run in
``pl.pallas_call(..., interpret=True)`` with the tool's BlockSpecs at a few
blocks of 8 or 16 rows. On the CPU the port's wrappers run their plain
PyTorch versions. The tool's chain feeds T12's starts back as the next mask,
which reaches a fixed point after one link, so single links on random masks
are compared too. T13's bodies are compared on the tool's domain, ``0 <= p <
65536``; outside it they disagree with each other (asserted here, ROADMAP.md
§3), and the port takes p to 16 bits. Every comparison is exact (tolerance
0); inputs come from numpy ``default_rng(seed)``.
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

from blt_tpu.utils import compcache
from blt_tpu_torch.ops import tools_cuda
from blt_tpu_torch.tools import exp_bf16scan, exp_gather

REPO = Path(__file__).resolve().parent.parent
LANES = 128


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


JAX_SCAN = _jax_tool("exp_bf16scan")
JAX_GATHER = _jax_tool("exp_gather")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- T12 --------------------------------------------------------------------------


def _scan_pallas(which, mask, rpb, k=1):
    """exp_bf16scan.chain's calls in interpret mode at ``rpb`` rows per
    block, each output the next input."""
    kern = JAX_SCAN._scan_i32_kernel if which == "i32" else JAX_SCAN._scan_bf16_kernel
    rows = mask.shape[0]
    x = jnp.asarray(mask)
    for _ in range(k):
        x = pl.pallas_call(
            kern,
            grid=(rows // rpb,),
            in_specs=[pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((rows, LANES), jnp.uint8),
            interpret=True,
        )(x)
    return np.asarray(x)


def _mask(seed, rows, density):
    """Nonzero bytes of any value (the tool's test is ``!= 0``) with the
    given density, a run of zeros and a row of ones."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((rows, LANES)) < density,
                 rng.integers(1, 256, (rows, LANES)), 0).astype(np.uint8)
    m[3] = 1  # a whole row of matches: the row scan falls back on the rows before
    m[9, :40] = 0
    return m


@pytest.mark.parametrize("which", list(exp_bf16scan.VARIANTS))
@pytest.mark.parametrize("rpb", [8, 16])
@pytest.mark.parametrize("density", [0.3, 0.7])
def test_mask_scan_equals_tool_kernel(which, rpb, density):
    mask = _mask(50, 32, density)
    ref = _scan_pallas(which, mask, rpb)
    got = tools_cuda.mask_scan(which, _t(mask), rpb)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(tools_cuda.mask_scan_plain(_t(mask), rpb).numpy(), ref)


@pytest.mark.parametrize("which", list(exp_bf16scan.VARIANTS))
def test_mask_scan_chain_equals_tool_chain(which):
    mask = _mask(51, 32, 0.5)
    for k in (1, 2, 3):
        assert np.array_equal(exp_bf16scan.chain(which, _t(mask), k, 8).numpy(),
                              _scan_pallas(which, mask, 8, k))


def test_mask_scan_is_block_local_and_reaches_a_fixed_point():
    """A block's first match run starts at its first position whatever the
    block before ends in; the starts fed back reproduce themselves."""
    mask = np.ones((32, LANES), np.uint8)
    mask[7, 127] = 0  # block 0 (rows 0..7) ends in a zero
    out = tools_cuda.mask_scan_plain(_t(mask), 8).numpy().reshape(-1)
    block = 8 * LANES
    assert out[0] == 1 and out[block] == 1 and out[block + 1] == 0
    assert out[2 * block] == 1
    once = tools_cuda.mask_scan_plain(_t(mask), 8)
    assert torch.equal(tools_cuda.mask_scan_plain(once, 8), once)


def test_the_tool_kernels_agree_with_each_other():
    mask = _mask(52, 32, 0.4)
    assert np.array_equal(_scan_pallas("i32", mask, 16), _scan_pallas("bf16", mask, 16))


def test_mask_scan_refuses_what_its_kernel_does_not_take():
    mask = _t(_mask(53, 24, 0.3))
    with pytest.raises(ValueError, match="unknown variant"):
        tools_cuda.mask_scan("f16", mask, 8)
    with pytest.raises(ValueError, match="whole blocks"):
        tools_cuda.mask_scan("i32", mask, 16)
    with pytest.raises(ValueError, match="uint8"):
        tools_cuda.mask_scan("bf16", mask.to(torch.int32), 8)


# --- T13 --------------------------------------------------------------------------

GATHER_ROWS = 16
GATHER_RPB = 8
BODIES = {"chain": "body_chain", "g2d": "body_g2d", "g2d_flat": "body_g2d_flat",
          "gax0": "body_gax0", "g8bit": "body_g8bit"}


@pytest.fixture(scope="module")
def gather_setup():
    """Both sides' tables, equal, and the tool's once / chained (k 3) per
    body at 16 rows and 8 rows per block."""
    val16, packed = JAX_GATHER.build_table()
    port_val16, port_packed = exp_gather.build_table()
    assert np.array_equal(val16, port_val16) and np.array_equal(packed, port_packed)
    tbl8 = exp_gather.build_tbl8()
    assert np.array_equal(tbl8, (np.arange(4096, dtype=np.int64) * 2654435761 % 251)
                          .astype(np.uint8).reshape(32, LANES))
    fns = {v: JAX_GATHER.make_pallas(getattr(JAX_GATHER, body),
                                     tbl8 if v == "g8bit" else packed, GATHER_ROWS, 3,
                                     interpret=True, rpb=GATHER_RPB)
           for v, body in BODIES.items()}
    tables = {v: _t(tbl8 if v == "g8bit" else packed) for v in BODIES}
    return val16, packed, tbl8, fns, tables


def _p(seed, lo=0, hi=65536):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (GATHER_ROWS, LANES), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("variant", list(tools_cuda.LOOKUPS))
def test_lookup_equals_tool_body_on_its_domain(gather_setup, variant):
    val16, packed, tbl8, fns, tables = gather_setup
    once, chained = fns[variant]
    p = _p(60)
    p[0, :4] = [0, 1, 65534, 65535]
    want = np.asarray(once(jnp.asarray(p)))
    assert np.array_equal(want, exp_gather.reference(variant, val16, packed, tbl8, p))
    assert np.array_equal(tools_cuda.lookup(variant, tables[variant], _t(p)).numpy(), want)
    assert np.array_equal(exp_gather.chained(variant, tables[variant], _t(p), 3).numpy(),
                          np.asarray(chained(jnp.asarray(p))))


def test_tool_bodies_disagree_outside_their_domain(gather_setup):
    """On record: past [0, 65536) the tool's three ``val16`` bodies give
    three answers, and ``gax0`` reads past its table's last row; the port
    takes p to 16 bits, so its designs agree with each other there."""
    val16, packed, _, fns, tables = gather_setup
    p = _p(61)
    p[0, :3] = [131071, -1, 65536 * 3 + 7]
    got = {v: np.asarray(fns[v][0](jnp.asarray(p)))[0, :3].tolist()
           for v in ("chain", "g2d", "g2d_flat", "gax0")}
    assert got["chain"] == [0, 0, 0]
    assert got["g2d"] == [19922, 19922, 41547]
    assert got["g2d_flat"] == [32768, 19922, 32768]
    assert got["gax0"][0] == got["gax0"][2] == -(2**31)
    want = val16[p & 0xFFFF].astype(np.int32)
    assert want[0, :3].tolist() == [19922, 19922, int(val16[7])]
    for variant in ("chain", "g2d", "g2d_flat"):
        assert np.array_equal(tools_cuda.lookup(variant, tables[variant], _t(p)).numpy(), want)


def test_lookup_takes_p_to_16_bits_everywhere(gather_setup):
    _, _, _, _, tables = gather_setup
    p = _p(62, -(2**31), 2**31 - 1)
    for variant in tools_cuda.LOOKUPS:
        got = tools_cuda.lookup(variant, tables[variant], _t(p))
        assert torch.equal(got, tools_cuda.lookup(variant, tables[variant], _t(p & 0xFFFF)))
        c = _t(p[::-1].copy())
        link = tools_cuda.lookup(variant, tables[variant], _t(p), c)
        assert torch.equal(link, tools_cuda.lookup(variant, tables[variant],
                                                   _t(p) + (c & 1)))


def test_lookup_refuses_what_its_kernel_does_not_take(gather_setup):
    _, _, _, _, tables = gather_setup
    p = _t(_p(63))
    with pytest.raises(ValueError, match="unknown variant"):
        tools_cuda.lookup("pmxu_i8", tables["g2d"], p)
    with pytest.raises(ValueError, match="table"):
        tools_cuda.lookup("g8bit", tables["g2d"], p)
    with pytest.raises(ValueError, match="int32"):
        tools_cuda.lookup("g2d", tables["g2d"], p.to(torch.int64))
    with pytest.raises(ValueError, match="previous output"):
        tools_cuda.lookup("g2d", tables["g2d"], p, p[:8])
    with pytest.raises(ValueError, match="unknown variants"):
        exp_gather.measure(torch.device("cpu"), 1 << 16, 1, only=("mxu_fp8",))


def test_wrappers_count_no_launch_on_the_cpu(gather_setup):
    _, _, _, _, tables = gather_setup
    tools_cuda.reset_launches()
    for variant in tools_cuda.LOOKUPS:
        exp_gather.chained(variant, tables[variant], _t(_p(64)), 2)
    for which in exp_bf16scan.VARIANTS:
        exp_bf16scan.chain(which, _t(_mask(54, 16, 0.3)), 2, 8)
    assert all(v == 0 for v in tools_cuda.launches.values())


# --- the entry points, as processes ------------------------------------------------------


def _run_tool(tool, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the suite's other workers share the cores
    return subprocess.run([sys.executable, "-m", f"blt_tpu_torch.tools.{tool}", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


@pytest.mark.parametrize("tool,args", [("exp_bf16scan", ["--size-mib", "1", "--k", "3"]),
                                       ("exp_gather", ["--rows", "32", "--k", "3"])])
def test_entry_point_runs_on_the_cpu(tool, args):
    r = _run_tool(tool, "--device", "cpu", *args)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["tool"] == tool and out["exact"] is True and out["device"] == {"type": "cpu"}
    for row in out["rows"]:
        assert row["exact"] is True and row["graph"] is None and row["bound_ms"] > 0
        assert row["eager"]["ms_per_launch"]["n"] == 5
    names = [r["name"] for r in out["rows"]]
    if tool == "exp_bf16scan":
        assert names == ["i32", "bf16"] and out["k1_equal"] is True
    else:
        # the original's ten rows: T13's five, T14's two, its three XLA rows
        assert names == list(exp_gather.VARIANTS) and len(names) == 10 and out["p_rows"] == 32
        assert names[5:] == ["pmxu_i8", "pmxu_bf16", "xla_take", "mxu_bf16", "mxu_int8"]
        assert set(out["results"]) == set(names)
        assert all(r["rate"] > 0 for r in out["results"].values())
        # a single PyTorch call beside every kernel row, T13's probes too
        assert [r["library_ms"] is not None for r in out["rows"]] == [True] * 7 + [False] * 3
        assert [r["route"] for r in out["rows"]] == ["cuda"] * 7 + ["torch"] * 3


@pytest.mark.parametrize("tool", ["exp_bf16scan", "exp_gather"])
def test_entry_point_without_a_card_names_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run_tool(tool)
    assert r.returncode != 0 and "CUDA" in r.stderr
