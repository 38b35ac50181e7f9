"""T6's block-local scans (scan16, swarpack) and T13's chain lookup, their
Hopper designs' protocols played on the host, on the CPU.

``tools_cuda.block_scan`` launches ``csrc/scan_parts.cu``'s
``segment_scan``: one CTA per job of whole segments (``rpb`` x 128
positions, as many as fit in a tile, at least one), taken from a ticket,
streams the job's tiles in order with the running maximum carried from tile
to tile and reset at every segment start; swarpack first keeps the job's
match bits, then scans row pairs with the tool's SWAR steps, then emits. A
job publishes the start at its last position in a flag word; the job after
it reads that flag for ``consumed`` at its first position. A card is not
needed to check the protocol: here the jobs run as the kernel's threads do
(16 positions a thread, a tile's exclusive maximum across its threads),
interleaved in random orders with tickets handed out in order, at the
kernel's 4096-position tile and at a forced 64-position tile, and must equal
``block_scan_plain`` exactly; ``block_scan_plain`` must equal the tool's
``_variant_body`` in interpret mode on the same cases. Each T13 lookup's
grid (``tools_cuda.lookup_plan``) must cover every element once and stage
its table once a CTA. The mirrors' constants are read from the sources. The
kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

import importlib.util
import re
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

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "blt_tpu_torch" / "csrc"
LANES = 128
THREADS, PER = 256, 16  # threads of a CTA, positions of a thread
TILE = THREADS * PER
NEG = -(2**31) + 1
GUARD = 0x80008000

MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259,
          (32, 104): 260, (104, 104): 261, (112, 120): 262, (120, 0): 263,
          (0, 64): 264, (64, 97): 265, (255, 255): 0xFFFF, (97, 255): 266}
ALPHABET = b"aabbcc hhpx\x00ab@\xff"


def _constant(text: str, name: str) -> int:
    expr = re.search(rf"constexpr (?:int|uint32_t) {name} = ([^;/]+);", text)[1]
    names = {"kSegTile": TILE, "kPer": PER}
    return eval(expr, {}, names)  # noqa: S307 - integer expressions of our sources


def test_mirror_constants_are_the_kernels():
    lookback = (CSRC / "max_lookback.cuh").read_text()
    assert (_constant(lookback, "kThreads"), _constant(lookback, "kPer")) == (THREADS, PER)
    scan = (CSRC / "scan_parts.cu").read_text()
    assert _constant(scan, "kSegThreads") * PER == TILE == tools_cuda.BLOCK_SCAN_TILE
    assert "constexpr int kSegTile = kSegThreads * kPer;" in scan
    assert _constant(scan, "kStageBytes") == TILE + PER and _constant(scan, "kStages") == 2
    # the job rule of jobs_of is the plan's
    assert "j.job = (kSegTile / j.seg > 1 ? kSegTile / j.seg : 1) * j.seg;" in scan
    lookup = (CSRC / "lookup.cu").read_text()
    assert _constant(lookup, "kLookupThreads") == tools_cuda.LOOKUP_THREADS
    assert _constant(lookup, "kUnroll") == tools_cuda.LOOKUP_UNROLL
    per_cta = {v: _constant(lookup, "kFlatPerCta" if v == "g2d_flat" else
                            "kTbl8PerCta" if v == "g8bit" else "kPackedPerCta")
               for v in tools_cuda.LOOKUPS}
    assert per_cta == tools_cuda.LOOKUP_PER_CTA
    staged = {"g2d_flat": 0, "g8bit": _constant(lookup, "kTbl8Bytes")}
    assert {v: staged.get(v, _constant(lookup, "kPackedBytes")) for v in tools_cuda.LOOKUPS} == (
        tools_cuda.LOOKUP_STAGED)
    assert ("constexpr int kStaged = V == kG2dFlat ? 0 : V == kG8bit ? kTbl8Bytes : "
            "kPackedBytes;") in lookup
    assert ("constexpr int kPerCta = V == kG2dFlat ? kFlatPerCta : V == kG8bit ? kTbl8PerCta : "
            "kPackedPerCta;") in lookup
    # the select chain and the thread-loop staging are gone: one read of the
    # table an element, staged by bulk copies
    assert "for (int s = 0; s < 256; ++s)" not in lookup
    assert "for (int k = threadIdx.x;" not in lookup
    assert "return unpack(t[q >> 1], q);" in lookup and "stage(" in lookup


# --- the plans -------------------------------------------------------------------


@pytest.mark.parametrize("rpb", [8, 16, 24, 32, 40, 1024])
def test_block_scan_plan_tiles_the_buffer_in_whole_segments(rpb):
    seg = rpb * LANES
    for segments in (1, 3, 7, 64):
        cap = segments * seg
        plan = tools_cuda.block_scan_plan(cap, rpb)
        assert plan["segment"] == seg and plan["job"] % seg == 0
        assert plan["job"] == seg if seg > TILE // 2 else plan["job"] <= TILE
        assert plan["tiles"] == -(-plan["job"] // TILE)
        spans = [(j * plan["job"], min((j + 1) * plan["job"], cap)) for j in range(plan["jobs"])]
        assert spans[-1][1] == cap and all(hi > lo and (hi - lo) % seg == 0 for lo, hi in spans)
        assert plan["scratch"] == plan["jobs"] + 1


def _check_lookup_plan(variant, n, ctas_per_sm):
    plan = tools_cuda.lookup_plan(variant, n, ctas_per_sm=ctas_per_sm)
    cap = 132 * ctas_per_sm
    assert 1 <= plan["ctas"] <= cap and plan["stride"] == plan["ctas"] * tools_cuda.LOOKUP_THREADS
    assert plan["ctas"] == min(cap, -(-n // tools_cuda.LOOKUP_PER_CTA[variant]))
    assert plan["staged_bytes"] == plan["ctas"] * {"g2d_flat": 0, "g8bit": 32 * LANES}.get(
        variant, 4 * 256 * LANES)
    # thread g takes groups g + (s * unroll + u) * stride while below groups
    hits = np.zeros(plan["groups"], np.int64)
    for s in range(plan["steps"] + 1):
        for u in range(tools_cuda.LOOKUP_UNROLL):
            g = np.arange(plan["stride"]) + (s * tools_cuda.LOOKUP_UNROLL + u) * plan["stride"]
            np.add.at(hits, g[g < plan["groups"]], 1)
    assert (hits == 1).all() and plan["groups"] * 4 == n
    assert plan["steps"] * tools_cuda.LOOKUP_UNROLL * plan["stride"] >= plan["groups"]


@pytest.mark.parametrize("rows", [1, 1000, 4096, 131072])
def test_lookup_chain_plan_covers_every_element_once(rows):
    _check_lookup_plan("chain", rows * LANES, 1)


@pytest.mark.parametrize("rows", [1, 1000, 4096, 131072])
@pytest.mark.parametrize("variant,ctas_per_sm", [("g2d", 1), ("gax0", 1), ("g2d_flat", 1),
                                                 ("g2d_flat", 2), ("g8bit", 1), ("g8bit", 2)])
def test_lookup_plan_covers_every_element_once(variant, ctas_per_sm, rows):
    """Every variant's grid (one CTA an SM for the 128 KiB tables; g2d_flat
    and g8bit as many as the occupancy query gives) covers each group of 4
    once, and its CTAs stage the table's bytes once each."""
    _check_lookup_plan(variant, rows * LANES, ctas_per_sm)


def test_lookup_plan_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        tools_cuda.lookup_plan("pmxu_i8", 4096)


# --- segment_scan, played on the host ----------------------------------------------


def _scan_starts(i0, match, run):
    """max_lookback.cuh's scan_starts, for a tile's threads at once (arrays
    of their i0, match bits and the last non-match before each)."""
    starts = np.zeros_like(i0)
    for k in range(PER):
        m = (match >> k) & 1 == 1
        run = np.where(m, run, i0 + k)
        starts |= np.where(m & ((i0 + k - run) & 1 == 1), 1 << k, 0)
    return starts


def _swar_step(s, c):
    """scan_parts.cu's swar_step in 32-bit arithmetic (``>>`` arithmetic),
    on int64 arrays holding u32 values."""
    g = ((s | GUARD) - c) & GUARD
    gs = np.where(g >= 1 << 31, g - (1 << 32), g)
    k = ((g - ((gs >> 15) & 0xFFFFFFFF)) & 0xFFFFFFFF) | g
    return ((s & k) | (c & ~k)) & 0xFFFFFFFF


def _swar_pairs(me, mo):
    """swar_pair over row pairs' 128 lanes (match bits me, mo: one row a
    pair): the Hillis-Steele steps read lane l - sh, 0 below sh."""
    lane = np.arange(LANES, dtype=np.int64)
    code = lambda m: np.where(m, 0, (lane + 1) * 2 + (lane & 1))  # noqa: E731
    s = (code(me) & 0x7FFF) | (code(mo) << 16)
    sh = 1
    while sh < LANES:
        c = np.concatenate([np.zeros((s.shape[0], sh), np.int64), s[:, :-sh]], 1)
        s = _swar_step(s, c)
        sh *= 2
    return s


class SegmentScan:
    """``segment_scan`` over one buffer, its jobs played as generators that
    yield at each tile and while they wait for a flag."""

    def __init__(self, variant, data, n, next_byte, table, carry, rpb, tile):
        d, val, m = bpe_cuda.flat_pairs_plain(torch.from_numpy(data), n, next_byte, table)
        self.d, self.val, self.m = d.numpy(), val.numpy(), m.numpy()
        self.swar = variant == "swarpack"
        self.cap, self.n, self.carry, self.tile = data.shape[0], n, carry, tile
        self.seg = rpb * LANES
        self.job = max(1, tile // self.seg) * self.seg
        self.jobs = -(-self.cap // self.job)
        self.slots = np.full(self.cap, -1, np.int64)
        self.flags = [0] * self.jobs
        self.carry_out = carry if n == 0 else None

    def _tile_scan(self, tile0, job_end):
        """The tile's threads: their i0, liveness, match bits and exclusive
        maximum across the tile's threads (block_excl_max); the tile's
        maximum."""
        i0s = tile0 + PER * np.arange(self.tile // PER, dtype=np.int64)
        live = i0s < job_end
        pos = i0s[:, None] + np.arange(PER)
        mm = self.m[np.minimum(pos, self.cap - 1)] & live[:, None]
        match = (mm.astype(np.int64) << np.arange(PER)).sum(1)
        mx = np.where(live & ~mm.all(1), np.where(~mm, pos, NEG).max(1), NEG)
        excl = np.concatenate([[NEG], np.maximum.accumulate(mx)[:-1]])
        return i0s, live, match, excl, int(mx.max())

    def _store(self, i0s, starts, consumed):
        """The 16 slots of each thread at i0s (store_slots)."""
        k = np.arange(PER)
        i = (i0s[:, None] + k).reshape(-1)
        bit = lambda w: ((w[:, None] >> k) & 1).reshape(-1) == 1  # noqa: E731
        self.slots[i] = np.where(bit(consumed), 0, np.where(
            bit(starts), self.val[i].astype(np.int64) & 0xFFFF, self.d[i].astype(np.int64) << 8))

    def run_job(self, j):
        job0 = j * self.job
        job_end = min(job0 + self.job, self.cap)
        tiles = -(-(job_end - job0) // self.tile)
        last = self.n - 1
        run = job0 - 1
        if not self.swar:
            prev_last = 0
            for k in range(tiles):
                i0s, live, match, excl, tile_max = self._tile_scan(job0 + k * self.tile, job_end)
                seg0 = job0 + (i0s - job0) // self.seg * self.seg
                starts = np.where(live, _scan_starts(i0s, match, np.maximum(
                    np.maximum(run, excl), seg0 - 1)), 0)
                run = max(run, tile_max)
                last_start = (starts >> (PER - 1)) & 1
                prev = np.concatenate([[prev_last], last_start[:-1]])
                self._store(i0s[live], starts[live], ((starts << 1) | prev)[live])
                owner = live & (i0s + PER == job_end)
                if owner.any():
                    self.flags[j] = 2 | int(last_start[owner][0])
                mine = live & (i0s <= last) & (last < i0s + PER)
                if mine.any():
                    self.carry_out = int(starts[mine][0] >> (last - int(i0s[mine][0]))) & 1
                prev_last = int(last_start[-1])
                yield
        else:
            rows = (job_end - job0) // LANES
            mbits = np.zeros((rows, LANES), bool)
            rpar = np.zeros(rows, np.int64)
            for k in range(tiles):
                i0s, live, match, excl, tile_max = self._tile_scan(job0 + k * self.tile, job_end)
                for t in np.nonzero(live)[0]:
                    r, lane0 = divmod(int(i0s[t]) - job0, LANES)
                    mbits[r, lane0 : lane0 + PER] = (int(match[t]) >> np.arange(PER)) & 1
                    if lane0 == 0:
                        seg0 = job0 + (int(i0s[t]) - job0) // self.seg * self.seg
                        rpar[r] = max(run, int(excl[t]), seg0 - 1) & 1
                run = max(run, tile_max)
                yield
            rpb = self.seg // LANES
            half = rpb // 2
            sbits = np.zeros((rows, LANES), bool)
            lane = np.arange(LANES)
            for r0 in range(0, rows, rpb):
                s = _swar_pairs(mbits[r0 : r0 + rpb : 2], mbits[r0 + 1 : r0 + rpb : 2])
                for h in range(2):
                    rows_h = slice(r0 + h * half, r0 + (h + 1) * half)
                    f = (s >> 16) & 0xFFFF if h else s & 0xFFFF
                    par = np.where(f > 0, f & 1, rpar[rows_h, None])
                    sbits[rows_h] = mbits[rows_h] & (((lane & 1) ^ par) == 1)
            yield
            flat = sbits.reshape(-1)
            self.flags[j] = 2 | int(flat[-1])
            if job0 <= last < job_end:
                self.carry_out = int(flat[last - job0])
            bits = flat.reshape(-1, PER).astype(np.int64)
            starts = (bits << np.arange(PER)).sum(1)
            prev = np.concatenate([[0], bits[:-1, -1]])
            self._store(np.arange(job0, job_end, PER), starts, (starts << 1) | prev)
            yield
        if j == 0:
            prev = int(self.carry != 0)
        else:
            while self.flags[j - 1] == 0:
                yield
            prev = self.flags[j - 1] & 1
        if prev:
            self.slots[job0] = 0

    def play(self, rng, resident):
        """Runs every job, at most ``resident`` at once: tickets in order,
        each step advancing a random job or starting the next."""
        active, started = [], 0
        for _ in range(100 * self.jobs * (self.job // self.tile + 4) + 100):
            room = len(active) < resident and rng.random() < 0.5
            if started < self.jobs and (room or not active):
                active.append(self.run_job(started))
                started += 1
                continue
            if not active:
                break
            g = active[rng.integers(len(active))]
            try:
                next(g)
            except StopIteration:
                active.remove(g)
        assert not active and started == self.jobs, "the jobs did not finish"
        assert (self.slots >= 0).all()
        return (torch.from_numpy(self.slots.astype(np.uint16)),
                torch.tensor([[self.carry_out]], dtype=torch.int32))


def _buffer(rpb, segments, seed):
    """Random text of ``segments`` segments in which every segment ends in
    a start for both variants: its last row all (a, a) matches, the pair
    before that row (x, a) no rule at an even position, and the segment's
    last pair (a, b) a rule. In swarpack the last row's fields are then 0,
    so its parity is the earlier rows' (even)."""
    seg = rpb * LANES
    data = np.random.default_rng(seed).choice(np.frombuffer(ALPHABET, np.uint8), segments * seg)
    for s in range(seg, segments * seg, seg):
        data[s - LANES - 2] = ord("x")
        data[s - LANES - 1 : s] = ord("a")
        data[s] = ord("b")
    data[-2:] = np.frombuffer(b"xa", np.uint8)  # (a, next_byte 98) is a rule
    return data.astype(np.uint8)


@pytest.fixture(scope="module")
def table():
    return wire_table(MergeTable.build(MERGES).dense)


SEGMENTS = {8: 9, 16: 5, 1024: 2}
# (rpb, tile): the kernel's tile, where rpb 8 and 16 put 4 and 2 segments in
# a job and 1024 streams 32 tiles a job, and a forced 64-position tile, where
# every segment spans many tiles
PLAYS = [(8, TILE), (16, TILE), (1024, TILE), (8, 64), (16, 64)]


@pytest.mark.parametrize("variant", tools_cuda.BLOCK_SCANS)
@pytest.mark.parametrize("rpb,tile", PLAYS)
@pytest.mark.parametrize("carry", [0, 1])
def test_segment_scan_played_in_random_orders_equals_plain(table, variant, rpb, tile, carry):
    data = _buffer(rpb, SEGMENTS[rpb], seed=rpb + carry)
    cap = data.shape[0]
    c = torch.tensor([[carry]], dtype=torch.int32)
    rng = np.random.default_rng(7 * rpb + tile + carry)
    for n in (cap, 3001, 1):
        for nb in (-1, 98):
            want = tools_cuda.block_scan_plain(variant, torch.from_numpy(data), n, nb, table, c,
                                               rpb)
            for resident in (1, 3):
                got = SegmentScan(variant, data, n, nb, table, carry, rpb, tile).play(rng, resident)
                assert torch.equal(got[0], want[0]), (n, nb, resident)
                assert torch.equal(got[1], want[1]), (n, nb, resident)
            if nb == -1 and n == cap:
                # every segment ends in a start, so the next one's first slot is consumed
                slots = want[0].numpy()
                assert all(slots[s] == 0 for s in range(rpb * LANES, cap, rpb * LANES))


# --- the plain version against the tool's kernel body ----------------------------------


def _jax_scan_tool():
    """``tools/exp_scan.py``, loaded by path (not a package); the checkout
    path it puts on ``sys.path`` is taken back out, and the compile cache it
    enables at load is left as it was."""
    spec = importlib.util.spec_from_file_location("jax_tools_exp_scan_segments",
                                                  REPO / "tools" / "exp_scan.py")
    mod = importlib.util.module_from_spec(spec)
    saved, enabled = sys.path[:], compcache._enabled
    compcache._enabled = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
        compcache._enabled = enabled
    return mod


JAX_SCAN = _jax_scan_tool()


def _tool_pass(variant, data, n, next_byte, carry, enc, rpb):
    """One call of exp_scan._pallas's grid spec in interpret mode, the
    8-row halo at the next block's first rows (K2's map; the tool's own map
    ``i + 1`` is the same at rpb 8, see tests/test_torch_ablations.py)."""
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
            pl.BlockSpec((8, LANES), lambda i: ((i + 1) * rpb // 8, 0), memory_space=pltpu.VMEM),
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
    out, c = call(enc.params(n, next_byte), jnp.asarray(np.full((1, 1), carry, np.int32)),
                  data3, data3, enc.e1, enc.e2)
    return np.asarray(out).reshape(-1), np.asarray(c)


@pytest.fixture(scope="module")
def chd():
    """The CHD placement the tool's body probes (the same rules as the
    port's wire table, (255, 255) -> 0xFFFF included)."""
    enc = bpe_pallas.PallasFlatEncoder(JaxMergeTable.build(MERGES), interpret=True,
                                       capacity_bytes=4 * 8 * LANES, rows_per_block=8)
    assert enc.mode in ("chd", "perfect"), enc.mode
    return enc


@pytest.mark.parametrize("variant", tools_cuda.BLOCK_SCANS)
@pytest.mark.parametrize("rpb", [8, 16, 1024])
def test_plain_equals_tool_body_on_the_played_cases(table, chd, variant, rpb):
    """block_scan_plain against the tool's body on the buffers played
    above: positions below n and the carry (the tool's block carry passes
    through blocks past n, which the port does not keep)."""
    data = _buffer(rpb, SEGMENTS[rpb], seed=rpb)
    cap = data.shape[0]
    for n, carry, nb in ((cap, 0, -1), (cap, 1, 98), (3001, 1, -1), (3001, 0, 98), (1, 1, 98)):
        c = torch.tensor([[carry]], dtype=torch.int32)
        ref, ref_c = _tool_pass(variant, data, n, nb, carry, chd, rpb)
        got, got_c = tools_cuda.block_scan_plain(variant, torch.from_numpy(data), n, nb, table, c,
                                                 rpb)
        assert np.array_equal(got.numpy()[:n], ref[:n]), (n, carry, nb)
        assert np.array_equal(got_c.numpy(), ref_c), (n, carry, nb)
