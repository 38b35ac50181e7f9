"""T12's mask scan, its Hopper design's protocol played on the host, on the
CPU.

``tools_cuda.mask_scan`` launches ``csrc/scan_parts.cu``'s ``mask_scan``:
one CTA a tile of ``kMaskUnroll`` sub-tiles, taken from a ticket; thread t
owns the 16 positions at ``u * kMaskSub + 16 t`` of each sub-tile u. Each
group contributes its last zero, or ``s - 1`` where it opens a segment at s
(the sentinel); the tile's exclusive maximum runs over its sub-tiles in
order (a warp scan, then the warps' totals), and across tiles a decoupled
look-back (``max_lookback.cuh``) carries one bit, the parity of the last
zero or sentinel before the tile. A tile that opens a segment publishes its
prefix and walks nowhere. A card is not needed to check the protocol: here
the tiles run as the kernel's threads do, started in random orders with
tickets handed out in order and their steps interleaved at random, at the
kernel's tile and at a forced small one, over rows per segment 8, 24, 1016
and 1024 and densities 0 to 1, and must equal ``mask_scan_plain`` exactly;
no look-back may read a tile before its segment's start. The bf16 variant's
lane scan is mirrored with its bf16 constants and its parity read through
f32, both checked against torch's bf16 and f32. ``mask_scan_plain`` must
equal the original's ``_scan_i32_kernel`` and ``_scan_bf16_kernel`` in
interpret mode on the same masks. The mirror's constants are read from the
sources. The kernels themselves are held against the plain version on the
card by tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

import importlib.util
import json
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

from blt_tpu.utils import compcache
from blt_tpu_torch.ops import tools_cuda

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "blt_tpu_torch" / "csrc"
LANES = 128
WARP = 32
THREADS, PER = 256, 16  # threads of a CTA, positions of a thread's group
UNROLL = 4  # groups a thread, one a sub-tile
TILE = UNROLL * THREADS * PER
NEG = -(2**31) + 1
AGGREGATE, PREFIX = 1 << 32, 2 << 32  # a status word's kinds
MAGIC = 12582912.0  # 1.5 * 2**23


def _constant(text: str, name: str) -> int:
    expr = re.search(rf"constexpr (?:int|unsigned long long) {name} = ([^;/]+);", text)[1]
    names = {"kThreads": THREADS, "kPer": PER, "kMaskUnroll": UNROLL,
             "kMaskSub": THREADS * PER}
    return eval(expr.replace("ull", ""), {}, names)  # noqa: S307 - integer expressions of our sources


def test_mirror_constants_are_the_kernels():
    lookback = (CSRC / "max_lookback.cuh").read_text()
    assert (_constant(lookback, "kThreads"), _constant(lookback, "kPer")) == (THREADS, PER)
    assert _constant(lookback, "kNeg") == NEG
    assert (_constant(lookback, "kAggregate"), _constant(lookback, "kPrefix")) == (AGGREGATE,
                                                                                   PREFIX)
    scan = (CSRC / "scan_parts.cu").read_text()
    assert _constant(scan, "kMaskUnroll") == UNROLL
    assert _constant(scan, "kMaskTile") == TILE == tools_cuda.MASK_SCAN_TILE
    assert "constexpr int kMaskTile = kMaskUnroll * kMaskSub;" in scan
    # one launch after one memset; the look-back is max_lookback.cuh's, not a copy
    body = scan[scan.index("// --- T12"):]
    assert "look_back(status, tile, par, 1)" in body and "cudaMemsetAsync" in body
    assert "look_back(unsigned long long" not in scan
    # the three-phase block kernel and its shared-memory rows are gone
    assert "lane_scan" not in scan and "(size_t)rpb * 5" not in scan
    assert re.search(r"f32 \(adding\s+// 1\.5 \* 2\^23", scan)
    assert "12582912.0f" in scan


@pytest.mark.parametrize("positions", [1024, TILE - 1024, TILE, TILE + 1024, 64 * 2**20])
def test_mask_scan_plan_covers_the_mask_in_tiles(positions):
    plan = tools_cuda.mask_scan_plan(positions)
    assert plan["tiles"] == -(-positions // TILE) and plan["scratch"] == plan["tiles"] + 1
    assert (plan["tiles"] - 1) * TILE < positions <= plan["tiles"] * TILE


# --- the bf16 lane scan's arithmetic ------------------------------------------------


def _bf16_of(n: int) -> int:
    """scan_parts.cu's constexpr bf16_of: the bf16 bits of 0 <= n < 256."""
    if n == 0:
        return 0
    e = n.bit_length() - 1
    return (127 + e) << 7 | ((n << (7 - e)) & 0x7F)


def _bf16_bits(values) -> np.ndarray:
    return torch.tensor(values, dtype=torch.float32).to(torch.bfloat16).view(torch.int16) \
        .numpy().astype(np.uint16)


def test_bf16_constants_are_torchs_bf16():
    assert [_bf16_of(n) for n in range(256)] == _bf16_bits(list(range(256))).tolist()
    text = (CSRC / "scan_parts.cu").read_text()
    one = int(re.search(r"kBf16MinusOne = (0x[0-9A-F]+);", text)[1], 16)
    two = int(re.search(r"kBf16MinusTwo = (0x[0-9A-F]+);", text)[1], 16)
    assert [one, two] == _bf16_bits([-1.0, -2.0]).tolist()
    # a lane plus an offset below 16 is exact in bf16, as the kernel's __hadd needs
    lanes = np.arange(0, 128, 16)[:, None] + np.arange(16)
    b = torch.from_numpy(np.arange(0, 128, 16)[:, None].astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(np.arange(16)[None].astype(np.float32)).to(torch.bfloat16)
    assert np.array_equal((b + k).float().numpy(), lanes)


def test_parity_through_f32_is_the_integers():
    """The bf16 variant reads a scanned value's parity as the lowest bit of
    float(value) + 1.5 * 2^23: exact for every value the scan holds."""
    v = np.arange(-2, 128)
    bits = (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).float().numpy()
            + np.float32(MAGIC)).view(np.uint32)
    assert np.array_equal(bits & 1, v & 1)


def _group_starts_bf16(i0, match, run):
    """group_starts<true> for many groups at once: lane values (i0 & 127) + k
    at a zero, else the run's parity as -1 or -2, scanned lane after lane;
    an even lane starts after an odd value, an odd lane after an even one."""
    none = np.where(run & 1 == 1, -1, -2)
    prev = none
    starts = np.zeros_like(i0)
    for k in range(PER):
        m = (match >> k) & 1 == 1
        val = np.maximum(np.where(m, none, (i0 & 127) + k), prev)
        prev = val
        par = (np.float32(val) + np.float32(MAGIC)).view(np.uint32).astype(np.int64) & 1
        starts |= np.where(m & ((par ^ (k & 1)) == 1), 1 << k, 0)
    return starts


def _group_starts_i32(i0, match, run):
    """max_lookback.cuh's scan_starts for many groups at once."""
    starts = np.zeros_like(i0)
    for k in range(PER):
        m = (match >> k) & 1 == 1
        run = np.where(m, run, i0 + k)
        starts |= np.where(m & ((i0 + k - run) & 1 == 1), 1 << k, 0)
    return starts


# --- mask_scan, played on the host ---------------------------------------------------


class MaskScan:
    """``mask_scan`` over one mask, its tiles played as generators that yield
    at each step of the look-back; ``threads`` and ``unroll`` shape the tile
    as the kernel's kThreads and kMaskUnroll do."""

    def __init__(self, variant, mask, rpb, threads=THREADS, unroll=UNROLL):
        self.m = mask.reshape(-1) != 0
        self.n = self.m.shape[0]
        self.seg = rpb * LANES
        self.threads, self.unroll = threads, unroll
        self.sub = threads * PER
        self.tile = unroll * self.sub
        self.tiles = -(-self.n // self.tile)
        self.starts = _group_starts_bf16 if variant == "bf16" else _group_starts_i32
        self.status = [0] * self.tiles
        self.ticket = 0
        self.out = np.full(self.n, 2, np.uint8)  # 2: not written
        self.first = {}  # tile -> the kind it published first
        self.read = {}  # tile -> the tiles its look-back read

    def _publish(self, tile, word):
        self.status[tile] = word
        self.first.setdefault(tile, "prefix" if word >= PREFIX else "aggregate")

    def _look_back(self, tile, agg):
        """max_lookback.cuh's look_back(status, tile, agg, 1), one read a step."""
        if agg != NEG:
            self._publish(tile, PREFIX | (agg & 0xFFFFFFFF))
        elif tile > 0:
            self._publish(tile, AGGREGATE | (NEG & 0xFFFFFFFF))
        yield
        excl = 1
        self.read[tile] = []
        for j in range(tile - 1, -1, -1):
            while self.status[j] == 0:
                yield
            self.read[tile].append(j)
            if self.status[j] >= PREFIX:
                excl = self.status[j] & 0xFFFFFFFF
                break
            yield
        if agg == NEG:
            self._publish(tile, PREFIX | (excl & 0xFFFFFFFF))
        return excl

    def run_cta(self):
        tile = self.ticket
        self.ticket += 1
        yield
        base = tile * self.tile
        head = base % self.seg
        t = np.arange(self.threads)
        i0 = (np.arange(self.unroll)[:, None] * self.sub + PER * t).astype(np.int64)  # [u, t]
        live = base + i0 < self.n
        pos = np.minimum(base + i0[..., None] + np.arange(PER), self.n - 1)
        match = np.where(live, (self.m[pos] << np.arange(PER)).sum(-1), 0xFFFF)
        sentinel = np.where(live & ((head + i0) % self.seg == 0), i0 - 1, NEG)
        nonmatch = ~match & 0xFFFF
        last = np.where(nonmatch != 0, i0 + np.log2(np.maximum(nonmatch, 1)).astype(np.int64),
                        NEG)
        c = np.maximum(last, sentinel)
        # warp scans, the warps' totals, then each group's exclusive maximum
        lane, warp = t % WARP, t // WARP
        incl = np.array([[c[u, (t - lane)[x]:x + 1].max() for x in t] for u in range(self.unroll)])
        warps = -(-self.threads // WARP)
        warp_tot = np.array([[incl[u, min((w + 1) * WARP, self.threads) - 1] for w in range(warps)]
                             for u in range(self.unroll)])
        agg = int(warp_tot.max())
        par = NEG if agg == NEG else agg & 1
        if head == 0:
            self._publish(tile, PREFIX | par)
            carry = 1
        else:
            carry = yield from self._look_back(tile, par)
        before = np.empty_like(c)
        for u in range(self.unroll):
            done = warp_tot[:u].max() if u else NEG
            pre = np.maximum(done, [warp_tot[u, :w].max() if w else NEG for w in warp])
            ex = np.concatenate([[NEG], incl[u, :-1]])
            before[u] = np.where(lane == 0, pre, np.maximum(pre, ex))
        run = np.maximum(np.maximum(before, -1 if carry else -2), sentinel)
        starts = self.starts(i0, match, run)
        k = np.arange(PER)
        for u, x in zip(*np.nonzero(live)):
            p0 = base + int(i0[u, x])
            self.out[p0:p0 + PER] = (int(starts[u, x]) >> k) & 1

    def play(self, rng, resident):
        """Runs every tile, at most ``resident`` CTAs at once, each step
        advancing a random CTA or starting the next (which takes the next
        ticket)."""
        active, started = [], 0
        while started < self.tiles or active:
            if started < self.tiles and (not active or (len(active) < resident
                                                        and rng.random() < 0.5)):
                active.append(self.run_cta())
                started += 1
                continue
            g = active[rng.integers(len(active))]
            try:
                next(g)
            except StopIteration:
                active.remove(g)
        assert self.ticket == self.tiles and (self.out < 2).all()
        return torch.from_numpy(self.out.reshape(-1, LANES))


def _mask(seed, rows, density):
    """Nonzero bytes of any value (the scan's test is ``!= 0``) with the given
    density."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((rows, LANES)) < density,
                    rng.integers(1, 256, (rows, LANES)), 0).astype(np.uint8)


# rows per segment -> segments: rpb 8 and 24 put many segments in a kernel
# tile (24's straddle tiles) and leave the last tile partial, 1016's
# segments end inside tiles, 1024's fill 8 tiles each
SEGMENTS = {8: 19, 24: 7, 1016: 2, 1024: 2}
# the forced small tile (threads, unroll): 64 positions, or 512 for the tall
# segments, so that every segment spans many tiles
SMALL = {8: (2, 2), 24: (2, 2), 1016: (16, 2), 1024: (16, 2)}


@pytest.mark.parametrize("variant", tools_cuda.MASK_SCANS)
@pytest.mark.parametrize("rpb", list(SEGMENTS))
@pytest.mark.parametrize("tile", ["kernel", "small"])
@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_mask_scan_played_in_random_orders_equals_plain(variant, rpb, tile, density):
    mask = _mask(rpb + int(10 * density), SEGMENTS[rpb] * rpb, density)
    want = tools_cuda.mask_scan_plain(torch.from_numpy(mask), rpb)
    shape = (THREADS, UNROLL) if tile == "kernel" else SMALL[rpb]
    rng = np.random.default_rng(rpb + int(100 * density))
    for resident in (1, 4):
        play = MaskScan(variant, mask, rpb, *shape)
        got = play.play(rng, resident)
        assert torch.equal(got, want), resident
        seg_of = lambda p: p // play.seg * play.seg  # noqa: E731
        for t, read in play.read.items():
            # no look-back reads a tile wholly before its segment's start
            assert all((j + 1) * play.tile > seg_of(t * play.tile) for j in read), (t, read)
        for t in range(play.tiles):
            lo, hi = t * play.tile, min((t + 1) * play.tile, play.n)
            if seg_of(hi - 1) >= lo:  # the tile holds a segment start
                assert play.first[t] == "prefix", t
            if lo % play.seg == 0:  # it opens one: no walk
                assert t not in play.read, t


@pytest.mark.parametrize("resident", [1, 200])
def test_all_ones_publish_aggregates_and_stop_at_their_segment(resident):
    """Density 1: every tile of a segment but its first publishes an
    aggregate first, and each walk ends at a prefix inside its segment; one
    CTA at a time, each finds its predecessor's prefix at once."""
    rpb = 24
    mask = np.ones((3 * rpb, LANES), np.uint8)
    play = MaskScan("i32", mask, rpb, 2, 2)
    got = play.play(np.random.default_rng(3), resident)
    assert torch.equal(got, tools_cuda.mask_scan_plain(torch.from_numpy(mask), rpb))
    per_seg = play.seg // play.tile
    assert sum(kind == "aggregate" for kind in play.first.values()) == play.tiles - 3
    for t, read in play.read.items():
        assert read[-1] >= t // per_seg * per_seg, (t, read)
        if resident == 1:
            assert read == [t - 1], (t, read)
    assert len(play.read) == play.tiles - 3


# --- the plain version against the original's kernels ----------------------------------


def _jax_scan_tool():
    """``tools/exp_bf16scan.py``, loaded by path (not a package); the
    checkout path it puts on ``sys.path`` is taken back out, and the compile
    cache it enables at load is left as it was."""
    spec = importlib.util.spec_from_file_location("jax_tools_exp_bf16scan_tiles",
                                                  REPO / "tools" / "exp_bf16scan.py")
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


def _scan_pallas(variant, mask, rpb):
    """One of exp_bf16scan.chain's calls in interpret mode at ``rpb`` rows
    per block."""
    kern = JAX_SCAN._scan_i32_kernel if variant == "i32" else JAX_SCAN._scan_bf16_kernel
    rows = mask.shape[0]
    return np.asarray(pl.pallas_call(
        kern,
        grid=(rows // rpb,),
        in_specs=[pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rpb, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, LANES), jnp.uint8),
        interpret=True,
    )(jnp.asarray(mask)))


@pytest.mark.parametrize("variant", tools_cuda.MASK_SCANS)
@pytest.mark.parametrize("rpb", [8, 24])
@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_plain_and_played_equal_the_original_kernels(variant, rpb, density):
    mask = _mask(7 * rpb + int(10 * density), 2 * rpb, density)
    ref = _scan_pallas(variant, mask, rpb)
    assert np.array_equal(tools_cuda.mask_scan_plain(torch.from_numpy(mask), rpb).numpy(), ref)
    got = MaskScan(variant, mask, rpb, *SMALL[rpb]).play(np.random.default_rng(rpb), 4)
    assert np.array_equal(got.numpy(), ref)


def test_exp_bf16scan_times_the_worst_case_density(capsys):
    """The tool's --density 1.0 (every tile of a block but its first waits on
    the one before) on the CPU: the plain chain, exact, the density reported."""
    from blt_tpu_torch.tools import exp_bf16scan

    assert exp_bf16scan.main(["--device", "cpu", "--size-mib", "1", "--k", "2",
                              "--density", "1.0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["density"] == 1.0 and out["exact"] and out["k1_equal"]
    assert [r["name"] for r in out["rows"]] == list(tools_cuda.MASK_SCANS)
