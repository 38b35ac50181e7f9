"""T10's noscan2, its Hopper design's protocol played on the host, on the CPU.

``tools_cuda.row_scan`` launches ``csrc/scan_parts.cu``'s ``row_scan_kernel``
once, after one memset of its flags and ticket: a CTA takes a tile of
kRowScanTile positions from the ticket, each thread 16 consecutive
positions of each of its kRowScanUnroll sub-tiles; the
row's last non-match before a thread is an 8-lane shuffle maximum, and each
thread computes its starts for block carry 0 and for 1. A block's carry out
is its start at ``last_pos = min(block end, n - 1)``, a 2-bit map of its
carry in; the tile holding ``last_pos`` publishes the map in the block's
flag at once, then the carry out once it knows its own carry. A ninth
warp, the control warp, finds the carry into the tile's first block by a
look-back over the blocks before it, 32 flags a read, composing maps until
a flag holds a carry (or ``carry_in`` past block 0), while the data warps
load; the maps of the three blocks just before it it computes itself from
their last rows, so it never waits on the tiles that publish them; blocks
wholly past n hold no flag and pass their carry. consumed at
a tile's first position inside a block is the previous row's last start,
which the control warp computes from that row's bytes.

A card is not needed to check the protocol: here the tiles run as the
kernel's threads do (a tile's kRowScanUnroll sub-tiles of 256 threads as
groups of 16 positions in order), in every order of a few tiles (each order a priority
of the CTAs, the first unblocked one advancing) and in random
interleavings of many, at rows per block 8, 16, 24 and 1024, n at the
capacity and inside a block, carry 0 and 1, next_byte -1 and 98, on text
and on an all-match buffer (every block's carry then depends on the one
before), and must equal ``row_scan_plain`` exactly; a CTA waits only on
flags of lower tickets, never on a block wholly past n. ``row_scan_plain``
and the play must equal the tool's Pallas chain (``tools/exp_chd.py``'s
``noscan2`` body in interpret mode, its CHD probe) on the same cases. The
mirror's constants are read from the source. The kernel itself is held
against the plain version on the card by tests/test_torch_gpu.py and
``chip_smoke.py``.
"""

import importlib.util
import itertools
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
THREADS, PER = 256, 16  # threads of a CTA, positions of a thread's group
UNROLL = 2  # groups a thread, one a sub-tile of THREADS * PER positions
GROUPS = THREADS * UNROLL  # groups of a tile
TILE = GROUPS * PER
NEG = -(2**31) + 1
BLOCK_MAP, BLOCK_CARRY = 4, 8  # flag kinds
WINDOW = 32  # flags the control warp's look-back reads at once
LOCAL_MAPS = 3  # block maps the control warp computes from their last rows
MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259,
          (32, 104): 260, (104, 104): 261, (112, 120): 262, (120, 0): 263,
          (0, 64): 264, (64, 97): 265}
ALPHABET = b"aabbcc hhpx\x00ab@"


def _constant(text: str, name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text)[1]
    names = {"kThreads": THREADS, "kPer": PER, "kTile": THREADS * PER,
             "kRowScanUnroll": UNROLL, "kRowScanTile": TILE}
    return eval(expr, {}, names)  # noqa: S307 - integer expressions of our sources


def test_mirror_constants_are_the_kernels():
    lookback = (CSRC / "max_lookback.cuh").read_text()
    assert re.search(r"constexpr int kThreads = 256;", lookback)
    assert re.search(r"constexpr int kPer = 16; ", lookback)
    scan = (CSRC / "scan_parts.cu").read_text()
    assert _constant(scan, "kRowScanUnroll") == UNROLL == tools_cuda.ROW_SCAN_UNROLL
    assert _constant(scan, "kRowScanTile") == TILE == tools_cuda.ROW_SCAN_TILE
    assert (_constant(scan, "kBlockMap"), _constant(scan, "kBlockCarry")) == (BLOCK_MAP,
                                                                              BLOCK_CARRY)
    assert _constant(scan, "kRowScanThreads") == THREADS + 32  # the control warp
    assert _constant(scan, "kLocalMaps") == LOCAL_MAPS <= 3  # its rows: 4 of 8 lanes
    # a tile meets at most TILE / 1024 + 1 blocks of at least 1024 positions
    assert _constant(scan, "kRowScanBlocks") >= TILE // (8 * LANES) + 1
    # one launch after one memset: the three-launch design (a block's carry
    # map, one thread's walk, the emit with its start bits in shared
    # memory) is gone
    body = scan[scan.index("// --- T10"):scan.index("// --- T12")]
    for gone in ("row_carry_map", "walk_carries", "row_scan_emit", "put_nibbles", "load4"):
        assert gone not in scan, gone
    launch = body[body.index("int launch_row_scan"):]
    assert launch.count("<<<") == 1 and launch.count("cudaMemsetAsync") == 1
    assert "(nb + 1) * sizeof(int)" in launch
    # each pair looked up once, the starts for both carries in registers,
    # bit-parallel
    assert body.count("staged_pairs(") == 1 and "scan_starts(" not in body
    assert body.count("parity_starts(match, before, st0, st1)") == 1


@pytest.mark.parametrize("rpb", [8, 16, 24, 1024])
@pytest.mark.parametrize("blocks", [1, 3, 64])
def test_row_scan_plan_covers_the_buffer(rpb, blocks):
    cap = blocks * rpb * LANES
    plan = tools_cuda.row_scan_plan(cap, rpb)
    assert plan["blocks"] == blocks and plan["tiles"] == -(-cap // TILE)
    assert (plan["tiles"] - 1) * TILE < cap <= plan["tiles"] * TILE
    assert plan["scratch"] == plan["blocks"] + 1


# --- row_scan_kernel, played on the host -----------------------------------------------


def _scan_starts(i0, match, run):
    """max_lookback.cuh's scan_starts for many threads at once."""
    starts = np.zeros_like(i0)
    for k in range(PER):
        m = (match >> k) & 1 == 1
        run = np.where(m, run, i0 + k)
        starts |= np.where(m & ((i0 + k - run) & 1 == 1), 1 << k, 0)
    return starts


def _parity_starts(match, before):
    """scan_parts.cu's parity_starts for many groups at once: (starts for
    carry 0, for carry 1)."""
    odd = 0xAAAA
    g = ~match & odd
    p = match
    for s in (1, 2, 4, 8):
        g = g | (p & (g << s))
        if s < 8:
            p = p & (p << s)
    lead = (~match & (match + 1)) - 1
    odd0 = np.where(before != NEG, before & 1, 1)
    odd1 = np.where(before != NEG, before & 1, 0)
    return tuple(match & (odd ^ (g | np.where(o == 1, lead, 0))) & 0xFFFF for o in (odd0, odd1))


@pytest.mark.parametrize("before", ["none", "odd", "even"])
def test_parity_starts_is_scan_starts(before):
    """Every 16-bit match word, at an even position i0 of a block starting
    at s, with the row's last non-match before it odd, even or none (the
    sentinel s - 1 - c): the bit-parallel starts equal scan_starts's."""
    match = np.arange(1 << 16, dtype=np.int64)
    i0, s = np.int64(4096 + 256), np.int64(4096)
    b = {"none": NEG, "odd": i0 - 3, "even": i0 - 6}[before]
    got = _parity_starts(match, np.full_like(match, b))
    for c in (0, 1):
        want = _scan_starts(np.full_like(match, i0), match,
                            np.full_like(match, max(b, s - 1 - c)))
        assert np.array_equal(got[c], want), c


def _compose(f, g):
    """f after g, maps of one bit (bit c: the value at c)."""
    return ((f >> (g & 1)) & 1) | (((f >> ((g >> 1) & 1)) & 1) << 1)


class RowScan:
    """``row_scan_kernel`` over one buffer, its CTAs played as generators
    that yield True where they wait on a flag not yet published, else
    False. A tile is ``groups`` groups of 16 positions in order: the
    kernel's kRowScanUnroll sub-tiles of kThreads threads (thread t's group
    of sub-tile u is group u * kThreads + t, and the start before it that of
    group u * kThreads + t - 1: the lane, the warp or the sub-tile before)."""

    def __init__(self, data, n, next_byte, table, carry, rpb, threads=GROUPS):
        d, val, m = bpe_cuda.flat_pairs_plain(torch.from_numpy(data), n, next_byte, table)
        self.d, self.val, self.m = d.numpy().astype(np.int64), val.numpy().astype(np.int64), \
            m.numpy()
        self.cap, self.n, self.carry_in = data.shape[0], n, carry
        self.seg = rpb * LANES
        self.nb = self.cap // self.seg
        self.threads = threads
        self.tile = threads * PER
        self.tiles = -(-self.cap // self.tile)
        self.block_flags = [0] * self.nb
        self.ticket = 0
        self.slots = np.full(self.cap, -1, np.int64)
        self.carry_out = None
        self.publisher = {}  # block -> the tile that published its map
        self.carrier = {}  # block -> the tile that published its carry
        self.maps = {}  # block -> its map
        self.read = {}  # tile -> the blocks whose flags its look-back read
        self.windows = {}  # tile -> the windows its look-backs read

    def _ends_here(self, j, base):
        lp = min((j + 1) * self.seg - 1, self.n - 1)
        return max(j * self.seg, base) <= lp < base + self.tile

    def _carry_into(self, tile, blk):
        """scan_parts.cu's carry_into (the control warp): windows of WINDOW
        flags, nearest first, each read at once until every flag up to the
        nearest carry is published (carry_in past block 0), composed from
        the nearest (a carry as the constant map); the next window where
        none holds a carry. It only reads: a block's carry is published by
        the tile that holds its last position alone."""
        g = 2  # the identity
        below_n = (self.n - 1) // self.seg + 1 if self.n > 0 else 0
        read = self.read.setdefault(tile, [])
        cin = BLOCK_CARRY | int(self.carry_in != 0)
        top = min(blk, below_n) - 1
        while True:
            js = range(top, top - WINDOW, -1)
            while True:
                w = [self.block_flags[j] if j >= 0 else cin for j in js]
                carries = [k for k, x in enumerate(w) if x & BLOCK_CARRY]
                last = carries[0] if carries else WINDOW - 1
                if all(w[: last + 1]):
                    break
                yield True
            read += [j for j in js[: last + 1] if j >= 0]
            self.windows[tile] = self.windows.get(tile, 0) + 1
            for x in w[: last + 1]:
                g = _compose(g, (3 if x & 1 else 0) if x & BLOCK_CARRY else x & 3)
            if carries:
                return g & 1
            top -= WINDOW
            yield False

    def _row_starts(self, row):
        """The starts of the 8 groups of the row at ``row`` for carry 0 and 1
        (the control warp's 8-lane rows)."""
        k = np.arange(PER)
        i0 = row + PER * np.arange(8)
        m = (self.m[i0[:, None] + k].astype(np.int64) << k).sum(1)
        non = ~m & 0xFFFF
        last = np.where(non != 0, i0 + np.log2(np.maximum(non, 1)).astype(np.int64), NEG)
        before = np.concatenate([[NEG], np.maximum.accumulate(last)[:-1]])
        s = i0 // self.seg * self.seg
        return [_scan_starts(i0, m, np.maximum(before, s - 1 - c)) for c in (0, 1)]

    def run_cta(self):
        tile = self.ticket
        self.ticket += 1
        yield False
        seg, n = self.seg, self.n
        base = tile * self.tile
        t = np.arange(self.threads)
        i0 = base + PER * t
        live = i0 < self.cap
        k = np.arange(PER)
        pos = np.minimum(i0[:, None] + k, self.cap - 1)
        match = np.where(live, (self.m[pos].astype(np.int64) << k).sum(1), 0)
        non = ~match & 0xFFFF
        last = np.where(live & (non != 0), i0 + np.log2(np.maximum(non, 1)).astype(np.int64), NEG)
        # the 8-lane row scan: the maximum over the row's threads before each
        rows = np.maximum.accumulate(last.reshape(-1, 8), axis=1)
        before = np.concatenate([np.full((rows.shape[0], 1), NEG), rows[:, :-1]], 1).reshape(-1)
        blk = i0 // seg
        s = blk * seg
        st = [np.where(live, _scan_starts(i0, match, np.maximum(before, s - 1 - c)), 0)
              for c in (0, 1)]
        last2 = ((st[0] >> 15) & 1) | (((st[1] >> 15) & 1) << 1)
        blk0 = base // seg
        lp = np.minimum(s + seg - 1, n - 1)
        holds = live & (i0 <= lp) & (lp < i0 + PER)  # the thread of its block's last_pos
        at = np.clip(lp - i0, 0, PER - 1)
        bits = ((st[0] >> at) & 1) | (((st[1] >> at) & 1) << 1)
        s_map = {int(j): int(b) for j, b in zip(blk[holds], bits[holds])}
        self.maps.update(s_map)
        # each map published by its thread at once
        for j, b in s_map.items():
            self.block_flags[j] = BLOCK_MAP | b
            self.publisher[j] = tile
        yield False

        # the control warp, meanwhile: the start before the tile inside a
        # block (the previous row's last, from that row's bytes), and the
        # carry into the first block: the maps of the LOCAL_MAPS nearest
        # blocks before it with a position below n, each from the row of its
        # last position, applied to the carry into the oldest of them from
        # the flags before it
        s_prev = 0
        if base % seg:
            hst = self._row_starts(base - LANES)
            s_prev = int(((hst[0][-1] >> 15) & 1) | (((hst[1][-1] >> 15) & 1) << 1))
        near = min(blk0, (n - 1) // seg + 1 if n > 0 else 0) - 1
        older = near - LOCAL_MAPS
        c = (yield from self._carry_into(tile, older + 1)) if older >= 0 else int(self.carry_in != 0)
        for j in range(near - LOCAL_MAPS + 1, near + 1):  # the local maps, oldest first
            if j < 0:
                continue
            lp = min((j + 1) * seg - 1, n - 1)
            jst = self._row_starts(lp - lp % LANES)
            c = int(jst[c][(lp % LANES) // PER] >> (lp % PER)) & 1
        yield False  # __syncthreads

        # 2. the control warp: the carries of the tile's later blocks
        blk_end = min((base + self.tile - 1) // seg, self.nb - 1)
        s_carry = {}
        for j in range(blk0, blk_end + 1):
            s_carry[j] = c
            lp = min((j + 1) * seg - 1, n - 1)
            if self._ends_here(j, base):
                c = (s_map[j] >> c) & 1
                assert j not in self.carrier
                self.block_flags[j] = BLOCK_CARRY | c
                self.carrier[j] = tile
                if lp == n - 1:
                    self.carry_out = c
            elif j * seg <= lp < base:  # the first block ended in an earlier tile
                c = yield from self._carry_into(tile, j + 1)
        if n == 0 and tile == 0:
            self.carry_out = int(self.carry_in != 0)
        yield False  # __syncthreads

        # 3. the slots, with each thread's block carry
        cc = np.array([s_carry.get(int(j), 0) for j in blk])
        # the start before each thread: the lane before, the warp before or
        # the sub-tile before (shared memory), or the row before the tile (the
        # control warp's); its block's carry at a block's first position
        p2 = np.concatenate([[s_prev], last2[:-1]])

        def slots_for(cc):
            starts = np.where(cc == 1, st[1], st[0])
            prev = np.where(i0 == s, cc, (p2 >> cc) & 1)
            consumed = (starts << 1) | prev
            return np.where((consumed[:, None] >> k) & 1 == 1, 0,
                            np.where((starts[:, None] >> k) & 1 == 1, self.val[pos],
                                     self.d[pos] << 8))

        self.slots[pos[live]] = slots_for(cc)[live]

    def _check(self):
        assert self.ticket == self.tiles and (self.slots >= 0).all()
        for tile, read in self.read.items():
            # waits only on lower tickets, never on a block wholly past n
            assert all(self.publisher[j] < tile and j * self.seg < self.n for j in read)
        # a block's map and carry come from the tile that holds its last position
        assert self.carrier == {j: self.publisher[j] for j in self.carrier}
        return (torch.from_numpy(self.slots.astype(np.uint16)),
                torch.tensor([[self.carry_out]], dtype=torch.int32))

    def play_random(self, rng, resident):
        """At most ``resident`` CTAs at once, each step advancing a random
        one or starting the next (which takes the next ticket)."""
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
        return self._check()

    def play_order(self, priority):
        """Every CTA started (tickets in order), then at each step the first
        CTA in ``priority`` that is not waiting advances; a step in which
        every CTA waits is a deadlock."""
        gens = [self.run_cta() for _ in range(self.tiles)]
        for g in gens:
            next(g)
        active = [gens[p] for p in priority]
        while active:
            for g in list(active):
                try:
                    if not next(g):
                        break
                except StopIteration:
                    active.remove(g)
                    break
            else:
                raise AssertionError("every CTA waits: a deadlock")
        return self._check()


def _buffer(kind, seed, rpb, blocks):
    cap = blocks * rpb * LANES
    if kind == "all match":
        return np.full(cap, 97, np.uint8)  # (97, 97) is a rule
    if kind == "mixed":
        # all match, but for a space in the last row of every fifth block:
        # those blocks' maps are constants, the others' the identity
        data = np.full(cap, 97, np.uint8)
        seg = rpb * LANES
        data[np.arange(2, blocks, 5) * seg + seg - LANES + 40] = 32
        return data
    rng = np.random.default_rng(seed)
    data = rng.choice(np.frombuffer(ALPHABET, np.uint8), cap).astype(np.uint8)
    data[1000:1300] = 97  # a run of (97, 97) over row and block edges
    return data


@pytest.fixture(scope="module")
def table():
    return wire_table(MergeTable.build(MERGES).dense)


def _carry(c):
    return torch.tensor([[c]], dtype=torch.int32)


# (rows per block, blocks, groups of the tile) for every order of four
# tiles: rpb 8 and 16 put 8 and 4 blocks in a kernel tile, rpb 24's blocks
# straddle tiles and leave the last one partial, and a tile of 4096 groups
# puts rpb 1024's blocks in 2 tiles each
EVERY_ORDER = [(8, 32, GROUPS), (16, 16, GROUPS), (24, 10, GROUPS), (1024, 2, 4096)]


@pytest.mark.parametrize("rpb,blocks,threads", EVERY_ORDER)
@pytest.mark.parametrize("kind", ["text", "all match"])
@pytest.mark.parametrize("n_at,carry,next_byte", [("cap", 0, -1), ("inside", 1, 98)])
def test_row_scan_played_in_every_order_equals_plain(table, rpb, blocks, threads, kind, n_at,
                                                     carry, next_byte):
    data = _buffer(kind, rpb + blocks, rpb, blocks)
    cap = data.shape[0]
    # n inside the second block: the blocks after it are wholly past n
    n = cap if n_at == "cap" else rpb * LANES + 3 * LANES + 5
    tiles = -(-cap // (threads * PER))
    assert tiles == 4
    want = tools_cuda.row_scan_plain(torch.from_numpy(data), n, next_byte, table, _carry(carry),
                                     rpb)
    for order in itertools.permutations(range(tiles)):
        got = RowScan(data, n, next_byte, table, carry, rpb, threads).play_order(order)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), order


@pytest.mark.parametrize("rpb,blocks,threads", [(8, 48, GROUPS), (16, 12, 64), (24, 8, 32),
                                                (1024, 3, GROUPS)])
@pytest.mark.parametrize("kind", ["text", "all match"])
def test_row_scan_played_in_random_orders_equals_plain(table, rpb, blocks, threads, kind):
    data = _buffer(kind, 7 * rpb, rpb, blocks)
    cap = data.shape[0]
    rng = np.random.default_rng(rpb + blocks)
    for n, carry, nb in ((cap, 1, -1), (cap - 3 * LANES - 1, 0, 98), (1, 1, 98), (0, 1, -1)):
        want = tools_cuda.row_scan_plain(torch.from_numpy(data), n, nb, table, _carry(carry), rpb)
        for resident in (1, 64):
            got = RowScan(data, n, nb, table, carry, rpb, threads).play_random(rng, resident)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n, carry,
                                                                                   resident)


def test_all_match_walks_compose_maps():
    """An all-match buffer at rpb 8 played one CTA at a time from the last
    ticket: every tile's look-back before its predecessor resolves composes
    the maps back to carry_in, and every block's map depends on its carry."""
    table = wire_table(MergeTable.build(MERGES).dense)
    rpb, blocks = 8, 5 * TILE // (8 * LANES)
    data = _buffer("all match", 0, rpb, blocks)
    play = RowScan(data, data.shape[0], -1, table, 1, rpb)
    got = play.play_order(list(range(play.tiles))[::-1])
    want = tools_cuda.row_scan_plain(torch.from_numpy(data), data.shape[0], -1, table, _carry(1),
                                     rpb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the last tile's first block takes the maps of the LOCAL_MAPS blocks
    # before it from their last rows, and walks back over every block
    # before those
    first = (play.tiles - 1) * TILE // (8 * LANES)
    assert play.read[play.tiles - 1] == list(range(first - LOCAL_MAPS - 1, -1, -1))
    # in ticket order each walk finds a carry in the flag before its block
    play = RowScan(data, data.shape[0], -1, table, 1, rpb)
    got = play.play_order(list(range(play.tiles)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 not in play.read and all(len(play.read[t]) == 1 for t in range(1, play.tiles))
    # every block's carry out depends on its carry in, but the last's (its
    # last pair takes next_byte -1: no match)
    assert all(w & BLOCK_CARRY for w in play.block_flags)
    assert all(play.maps[j] in (1, 2) for j in range(blocks - 1)) and play.maps[blocks - 1] == 0


@pytest.mark.parametrize("kind", ["all match", "mixed"])
def test_all_match_walks_cross_windows(kind):
    """An all-match buffer at rpb 8 over 12 tiles (96 blocks), played from
    the last ticket first: every tile past the first walks back over all
    the blocks before its local maps to carry_in, composing maps across up
    to three windows of WINDOW flags, since no carry is published before
    the walk ends; then in random interleavings. Each equals
    row_scan_plain. In the mixed buffer every fifth block's map is a
    constant and the rest the identity, so a walk's carry is the nearest
    constant's, not carry_in: the maps compose in order."""
    table = wire_table(MergeTable.build(MERGES).dense)
    rpb = 8
    per_tile = TILE // (rpb * LANES)
    blocks = 12 * per_tile
    data = _buffer(kind, 0, rpb, blocks)
    for carry in (0, 1):
        want = tools_cuda.row_scan_plain(torch.from_numpy(data), data.shape[0], -1, table,
                                         _carry(carry), rpb)
        play = RowScan(data, data.shape[0], -1, table, carry, rpb)
        got = play.play_order(list(range(play.tiles))[::-1])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), carry
        assert 0 not in play.read
        for t in range(1, play.tiles):
            older = t * per_tile - 1 - LOCAL_MAPS
            assert play.read[t] == list(range(older, -1, -1)), t
            assert play.windows[t] == (older + 1) // WINDOW + 1, t
        assert max(play.windows.values()) == 3
        maps = {play.maps[j] for j in range(blocks - 1)}
        # the identity, and in the mixed buffer constants beside it
        assert maps == {2} if kind == "all match" else (2 in maps and maps & {0, 3})
        rng = np.random.default_rng(carry)
        for resident in (3, 12):
            play = RowScan(data, data.shape[0], -1, table, carry, rpb)
            got = play.play_random(rng, resident)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), resident


# --- the plain version and the play against the tool's Pallas chain -------------------


def _jax_chd():
    """``tools/exp_chd.py``, loaded by path (not a package); the checkout
    path it puts on ``sys.path`` is taken back out, and the compile cache it
    enables at load is left as it was."""
    spec = importlib.util.spec_from_file_location("jax_tools_exp_chd_row_scan",
                                                  REPO / "tools" / "exp_chd.py")
    mod = importlib.util.module_from_spec(spec)
    saved, enabled = sys.path[:], compcache._enabled
    compcache._enabled = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
        compcache._enabled = enabled
    return mod


JAX_CHD = _jax_chd()


def _chd_pallas(data, n, next_byte, carry, rpb, k=1):
    """exp_chd.chain's grid spec for noscan2 in interpret mode over the CHD
    placement of MERGES, k calls chained through the carry."""
    cap = data.shape[0]
    enc = bpe_pallas.PallasFlatEncoder(JaxMergeTable.build(MERGES), interpret=True,
                                       capacity_bytes=cap, rows_per_block=rpb)
    assert enc.mode in ("chd", "perfect")
    rows = cap // LANES
    call = pl.pallas_call(
        JAX_CHD.make_kernel("noscan2"),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(rows // rpb,),
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
        out_shape=(jax.ShapeDtypeStruct((rows, LANES), jnp.uint16),
                   jax.ShapeDtypeStruct((1, 1), jnp.int32)),
        interpret=True,
    )
    buf = np.zeros(((rows + 8) * LANES,), np.uint8)
    buf[:cap] = data
    data3 = jnp.asarray(buf.reshape(rows + 8, LANES))
    c = jnp.asarray(np.full((1, 1), carry, np.int32))
    for _ in range(k):
        out, c = call(enc.params(n, next_byte), enc.segs, c, data3, data3, enc.e1, enc.e2)
    return np.asarray(out).reshape(-1), np.asarray(c)


# n at the capacity, inside the second block and 1, both carries, next_byte
# -1 and 98 at rpb 8 and 16; two of them at rpb 1024, which interpret mode
# runs slowly
CHAIN_CASES = [("cap", 0, -1), ("cap", 1, 98), ("inside", 1, -1), ("inside", 0, 98),
               ("one", 1, 98)]


@pytest.mark.parametrize("rpb,blocks,n_at,carry,next_byte",
                         [(8, 12, *c) for c in CHAIN_CASES] + [(16, 6, *c) for c in CHAIN_CASES]
                         + [(1024, 2, *c) for c in CHAIN_CASES[1:3]])
@pytest.mark.parametrize("kind", ["text", "all match"])
def test_plain_and_played_equal_the_tool_chain(table, rpb, blocks, kind, n_at, carry, next_byte):
    data = _buffer(kind, 3 * rpb, rpb, blocks)
    cap = data.shape[0]
    n = {"cap": cap, "inside": rpb * LANES + 5 * LANES + 3, "one": 1}[n_at]
    if n_at == "cap" and kind == "text":
        data[n - 1] = 97  # (97, 98) and (97, 97) are rules: the last pair takes next_byte
    ref = _chd_pallas(data, n, next_byte, carry, rpb)
    plain = tools_cuda.row_scan_plain(torch.from_numpy(data), n, next_byte, table, _carry(carry),
                                      rpb)
    assert np.array_equal(plain[0].numpy(), ref[0]) and np.array_equal(plain[1].numpy(), ref[1])
    got = RowScan(data, n, next_byte, table, carry, rpb).play_random(np.random.default_rng(rpb), 8)
    assert np.array_equal(got[0].numpy(), ref[0]) and np.array_equal(got[1].numpy(), ref[1])
