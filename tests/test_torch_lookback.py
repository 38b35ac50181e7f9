"""The one-launch K4 round and the fused K2 pass, their protocols played on
the host, on the CPU.

K4 on the main path (``multipass_cuda.K4_FLAGS``, ``csrc/token_pass.cuh``
``tile_lookback``) and K2 with its packed-wire epilogue
(``bpe_cuda.flat_encode_packed``, ``csrc/flat_bpe.cu``
``flat_packed_kernel``) each carry the parity scan's prefix maximum from
tile to tile by a decoupled look-back (``csrc/max_lookback.cuh``). A card
is not needed to check the protocol: here each tile publishes and walks
back as the kernels do, with the tiles' steps interleaved in random orders,
and must find the sequential prefix; each tile then emits from that prefix
as its threads do (16 positions a thread, the position before a thread's
first from the thread before, and before a tile's first from one more
lookup), and the result must equal the plain versions and the Pallas
kernels in interpret mode. The fused pass is also played at a forced
64-position tile, so that a short buffer crosses many tile edges. The
mirror's constants are read from the sources. Every comparison is exact.
The kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_tpu.merges import MergeTable as JaxMergeTable
from blt_tpu.ops import bpe_pallas as bp
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda
from blt_tpu_torch.ops.tables import cuckoo_planes, wire_table

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "blt_tpu_torch" / "csrc"
THREADS, PER = 256, 16  # threads of a CTA, positions of a thread
TILE = THREADS * PER
NEG = -(2**31) + 1
AGGREGATE, PREFIX = 1 << 32, 2 << 32  # a status word's kinds
CPU = torch.device("cpu")
RPB = 8  # Pallas rows per block in interpret mode: 1024-token blocks
K4_CAP = 3 * TILE + 1024  # three tiles and a short one, whole Pallas blocks

HIER = {(97, 98): 256, (256, 99): 257, (257, 257): 300,
        (120, 121): 90, (90, 122): 0, (0, 97): 400}
CHAIN = {(97, 97): 256, (256, 256): 257, (257, 257): 258, (258, 258): 259}
FLAT = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259, (255, 255): 0xFFFF}


def _constant(text: str, name: str) -> int:
    expr = re.search(rf"constexpr (?:int|unsigned long long) {name} = ([^;]+);", text)[1]
    return eval(expr.replace("ull", ""))  # noqa: S307 - integer literals of our sources


def test_mirror_constants_are_the_kernels():
    text = (CSRC / "max_lookback.cuh").read_text()
    assert (_constant(text, "kThreads"), _constant(text, "kPer")) == (THREADS, PER)
    assert _constant(text, "kNeg") == NEG == multipass_cuda._NEG
    assert (_constant(text, "kAggregate"), _constant(text, "kPrefix")) == (AGGREGATE, PREFIX)
    assert TILE == multipass_cuda._TILE == bpe_cuda._TILE
    # both look-back kernels include the shared protocol, and no copy of it
    for src in ("token_pass.cuh", "flat_pass.cuh"):
        body = (CSRC / src).read_text()
        assert '#include "max_lookback.cuh"' in body
        assert "look_back(unsigned long long" not in body and "constexpr int kNeg" not in body


def test_token_pass_instantiates_exactly_the_named_flag_sets():
    """``token_pass.cu`` instantiates the flag sets of ``TOKEN_PASSES``
    and no other; the main path's K4 is the look-back set."""
    text = (CSRC / "token_pass.cu").read_text()
    listed = re.search(r"TokenSets = std::integer_sequence<int,([^>]*)>", text)[1]
    assert sorted(int(x) for x in listed.split(",")) == sorted(
        f.bits for f in multipass_cuda.TOKEN_PASSES.values())
    assert multipass_cuda.K4_FLAGS.bits == 15 and multipass_cuda.K4_FLAGS.lookback


# --- the max look-back, played on the host ------------------------------------


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


def _s32(w: int) -> int:
    v = w & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def look_back(aggs, sentinel, rng):
    """Each tile's exclusive prefix by ``max_lookback.cuh``'s protocol, the
    tiles' steps interleaved in the order ``rng`` draws: a tile publishes
    its status word (its maximum as a prefix at once where it holds a
    non-match, else an aggregate; tile 0 nothing yet), then reads its
    predecessors' words nearest first, one read a step, waiting at one not
    yet published, until a prefix (or past tile 0: the sentinel), then
    publishes its prefix where it had not. Returns (the prefixes, the
    kind each tile published first)."""
    status = [0] * len(aggs)
    first = [None] * len(aggs)
    prefixes = [None] * len(aggs)

    def publish(t, word):
        status[t] = word
        if first[t] is None:
            first[t] = "prefix" if word >= PREFIX else "aggregate"

    def tile(t):
        agg = aggs[t]
        if agg != NEG:
            publish(t, PREFIX | _u32(agg))
        elif t > 0:
            publish(t, AGGREGATE | _u32(NEG))
        yield
        excl = sentinel
        for j in range(t - 1, -1, -1):
            while status[j] == 0:
                yield
            if status[j] >= PREFIX:
                excl = _s32(status[j])
                break
            yield
        if agg == NEG:
            publish(t, PREFIX | _u32(excl))
        prefixes[t] = excl

    running = {t: tile(t) for t in range(len(aggs))}
    while running:
        t = list(running)[int(rng.integers(len(running)))]
        if next(running[t], "done") == "done":
            del running[t]
    return prefixes, first


def tile_maxima(match: np.ndarray, tile: int) -> list:
    """Each tile's last non-match index, or NEG where every position matches."""
    out = []
    for t0 in range(0, match.shape[0], tile):
        non = np.flatnonzero(~match[t0 : t0 + tile])
        out.append(int(t0 + non[-1]) if non.size else NEG)
    return out


def sequential(aggs, sentinel) -> list:
    out, run = [], sentinel
    for a in aggs:
        out.append(run)
        run = max(run, a)
    return out


def thread_starts(i0: int, match: np.ndarray, run: int) -> np.ndarray:
    """``scan_starts``: the start bits of the 16 positions at i0."""
    starts = np.zeros(PER, bool)
    for k in range(PER):
        if not match[i0 + k]:
            run = i0 + k
        elif (i0 + k - run) & 1:
            starts[k] = True
    return starts


def thread_prefixes(match: np.ndarray, t0: int, tile: int, prefix: int) -> list:
    """Each thread's run origin before its first position: the tile's
    prefix, or the last non-match of the threads before it in the tile
    (``block_excl_max``)."""
    out, run = [], prefix
    for i0 in range(t0, t0 + tile, PER):
        out.append(run)
        non = np.flatnonzero(~match[i0 : i0 + PER])
        if non.size:
            run = max(run, i0 + int(non[-1]))
    return out


# --- K4 -----------------------------------------------------------------------


def _k4_pairs(toks: np.ndarray, n: int, planes):
    """Each position's match and value (``pair_at`` with lookup and shift)."""
    d = torch.from_numpy(toks)
    nxt = torch.zeros_like(d)
    nxt[:-1] = d[1:]
    hit, val = multipass_cuda._lookup(d, nxt, planes)
    match = hit.numpy() & (np.arange(toks.shape[0]) < n - 1)
    return match, val.numpy().astype(np.int64)


def k4_by_tiles(toks: np.ndarray, n: int, planes, rng):
    """K4's look-back round as its CTAs run it: (output, the kind each tile
    published first)."""
    cap = toks.shape[0]
    match, val = _k4_pairs(toks, n, planes)
    w = np.where(match, val, toks)  # what a position writes unless consumed
    aggs = tile_maxima(match, TILE)
    prefixes, first = look_back(aggs, -1, rng)
    assert prefixes == sequential(aggs, -1)
    out = np.empty(cap, np.int64)
    for t, t0 in enumerate(range(0, cap, TILE)):
        # thread 0: one more lookup, the pair at t0 - 1, and the prefix's parity
        before = False
        if t > 0:
            m, _ = _k4_pairs(toks[t0 - 1 : t0 + 1].copy(), n - (t0 - 1), planes)
            before = bool(m[0]) and bool((t0 - 1 - prefixes[t]) & 1)
        for i0, run in zip(range(t0, min(t0 + TILE, cap), PER),
                           thread_prefixes(match, t0, min(TILE, cap - t0), prefixes[t])):
            starts = thread_starts(i0, match, run)
            consumed = np.concatenate([[before], starts[:-1]])
            out[i0 : i0 + PER] = np.where(consumed, -1, w[i0 : i0 + PER])
            before = bool(starts[-1])
    return out.astype(np.int32), first


def _pallas_token_pass(merges, toks, n):
    k1, v1, k2, v2, a1, a2 = JaxMergeTable.build(merges).build_cuckoo32()
    shift = 32 - (k1.shape[0].bit_length() - 1)
    planes = [jnp.asarray(x.reshape(-1, 128)) for x in (k1, v1, k2, v2)]
    buf = np.zeros(toks.shape[0] + 8 * 128, np.int32)  # + the 8 halo rows
    buf[: toks.shape[0]] = toks
    params = jnp.asarray(np.array([n, a1, a2, shift, 0, 0, 0, 0], np.int32))
    out = bp._token_pass_call(params, jnp.asarray(buf.reshape(-1, 128)), *planes,
                              interpret=True, rows_per_block=RPB)
    return np.asarray(out).reshape(-1)[: toks.shape[0]]


def _k4_cases(rng):
    """(name, merges, K4_CAP tokens): random pairs; one match run over all
    of tile 1 (its 4096 positions hold no non-match);
    merges that start on the last position of tiles 0 and 1."""
    cap = K4_CAP
    alphabet = np.array([97, 98, 99, 120, 121, 122, 0, 256, 257], np.int32)
    random = rng.choice(alphabet, cap).astype(np.int32)
    run = rng.choice(np.array([98, 99, 256], np.int32), cap).astype(np.int32)
    run[TILE - 7 : 2 * TILE + 9] = 97  # every pair of tile 1 matches in CHAIN
    last = rng.choice(np.array([98, 99, 120], np.int32), cap).astype(np.int32)
    for edge in (TILE, 2 * TILE):
        last[edge - 2 : edge + 1] = [120, 97, 98]  # (120, 97) no rule, (97, 98) starts
    return [("random", HIER, random), ("all-match tile", CHAIN, run),
            ("start on a tile's last position", HIER, last)]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("n", [0, 1, 7, 8, 4095, 4096, 4097, K4_CAP])
def test_k4_look_back_round_equals_plain_and_pallas(case, n):
    rng = np.random.default_rng(case)
    name, merges, toks = _k4_cases(rng)[case]
    planes = cuckoo_planes(MergeTable.build(merges), CPU)
    got, first = k4_by_tiles(toks, n, planes, rng)
    plain = multipass_cuda.token_pass_plain(torch.from_numpy(toks), n, planes,
                                            multipass_cuda.K4_FLAGS)
    assert np.array_equal(got, plain.numpy()), (name, n)
    wrapped = multipass_cuda.token_pass(torch.from_numpy(toks), n, planes, multipass_cuda.K4_FLAGS)
    assert torch.equal(wrapped, plain)
    if n in (0, 4097, K4_CAP):
        assert np.array_equal(got, _pallas_token_pass(merges, toks, n)), (name, n)
    if name == "all-match tile" and n == K4_CAP:
        assert first == ["prefix", "aggregate", "prefix", "prefix"]
    if name == "start on a tile's last position" and n > 2 * TILE:
        assert got[TILE - 1] == got[2 * TILE - 1] == 256  # (97, 98) merged there
        assert got[TILE] == got[2 * TILE] == -1


@pytest.mark.parametrize("seed", range(3))
def test_look_back_gives_the_sequential_max_prefix(seed):
    """Random tile maxima, runs of all-match tiles among them, any
    sentinel: every interleaving gives the sequential exclusive maximum, and
    exactly the all-match tiles after tile 0 publish an aggregate first."""
    rng = np.random.default_rng(seed)
    aggs = [int(a) if rng.random() < 0.6 else NEG
            for a in np.sort(rng.integers(0, 1 << 30, 40))]
    aggs[0] = NEG
    sentinel = -1 - int(rng.integers(0, 2))
    for order in range(4):
        prefixes, first = look_back(aggs, sentinel, np.random.default_rng(100 + order))
        assert prefixes == sequential(aggs, sentinel)
        assert first == ["prefix"] + ["aggregate" if a == NEG else "prefix" for a in aggs[1:]]


# --- K2 with its packed wire ------------------------------------------------------


def _flat_pair(data, n, next_byte, table, i):
    """``pair_at`` of flat_pass.cuh at position i: (match, value)."""
    if i < n - 1:
        nx = int(data[i + 1])
    elif i == n - 1 and next_byte >= 0:
        nx = next_byte
    else:
        return False, 0
    v = int(table[int(data[i]) * 256 + nx])
    return v != 0, v


def _wire_byte(s: int, p: int):
    start, cons = (s & 0xFF) != 0, (p & 0xFF) != 0
    return (s & 0xFF) if start else ((p >> 8) & 0xFF) if cons else (s >> 8), start or cons


def packed_by_tiles(data, n, next_byte, table, carry, prev, threads, rng):
    """The fused pass as its CTAs run it, at ``threads`` threads of 16
    positions a tile: (wire, carry_out, last_slot)."""
    tile = threads * PER
    cap = data.shape[0]
    d, val, m = bpe_cuda.flat_pairs_plain(torch.from_numpy(data), n, next_byte,
                                          torch.from_numpy(table))
    d, val, match = d.numpy(), val.numpy(), m.numpy()
    aggs = tile_maxima(match, tile)
    prefixes, _ = look_back(aggs, -1 - carry, rng)
    assert prefixes == sequential(aggs, -1 - carry)
    wire = np.zeros(cap + cap // 8, np.uint8)
    carry_out, last_slot = carry, prev
    for t, t0 in enumerate(range(0, cap, tile)):
        if t == 0:  # the batch's first position: the inputs
            before_slot, before_start = prev & 0xFFFF, carry != 0
        else:  # one more lookup at t0 - 1; the prefix decides its start bit
            hit, v = _flat_pair(data, n, next_byte, table, t0 - 1)
            before_start = hit and bool((t0 - 1 - prefixes[t]) & 1)
            before_slot = v if before_start else 0
        for i0, run in zip(range(t0, min(t0 + tile, cap), PER),
                           thread_prefixes(match, t0, min(tile, cap - t0), prefixes[t])):
            starts = thread_starts(i0, match, run)
            consumed = np.concatenate([[before_start], starts[:-1]])
            slots = np.where(consumed, 0, np.where(starts, val[i0 : i0 + PER],
                                                   d[i0 : i0 + PER] << 8))
            p, flags = before_slot, 0
            for k in range(PER):
                wire[i0 + k], f = _wire_byte(int(slots[k]), p)
                flags |= f << k
                p = int(slots[k])
            wire[cap + i0 // 8 : cap + i0 // 8 + 2] = [flags & 0xFF, flags >> 8]
            if i0 <= n - 1 < i0 + PER:
                carry_out, last_slot = int(starts[n - 1 - i0]), int(slots[n - 1 - i0])
            before_slot, before_start = int(slots[-1]), bool(starts[-1])
    return wire, carry_out, last_slot


def _flat_table(rng):
    pairs = {(int(a), int(b)) for a, b in rng.integers(96, 100, (10, 2))} | set(FLAT)
    return wire_table(MergeTable.build({p: 256 + i for i, p in enumerate(sorted(pairs))})
                      .dense).numpy()


def _flat_data(rng, cap, tile):
    """Bytes of a small alphabet (long match runs), with (97, 98) placed to
    start a merge on the last position of every tile: (255, 97) has no
    rule, so the run restarts at the tile's last position."""
    data = rng.choice(np.frombuffer(b"aabbcc \xffab", np.uint8), cap).astype(np.uint8)
    for edge in range(tile, cap, tile):
        data[edge - 2 : edge + 1] = [32, 97, 98]
    return data


@pytest.mark.parametrize("threads", [4, THREADS])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 4095, 4096, 4097, 3 * TILE + 64])
def test_fused_pass_wire_equals_k2_then_pack(threads, n):
    """The wire built tile by tile from registers plus one lookup at each
    tile's i0 - 1 equals ``pack_slots_plain(flat_pass_plain(...))``, for
    carry_in 0 and 1, a prev_slot that is a merge start and one that is
    not, and next_byte -1 and a byte with a rule after the last."""
    rng = np.random.default_rng(threads * 10007 + n)
    cap = 3 * TILE + 64
    table = _flat_table(rng)
    data = _flat_data(rng, cap, threads * PER)
    for carry, prev, next_byte in ((0, 0, -1), (1, 0x0161, 98), (1, 0x6100, -1),
                                   (0, 0x0262, 97)):
        got = packed_by_tiles(data, n, next_byte, table, carry, prev, threads, rng)
        c = torch.tensor([[carry]], dtype=torch.int32)
        p = torch.tensor(prev, dtype=torch.int32)
        slots, c_out = bpe_cuda.flat_pass_plain(torch.from_numpy(data), n, next_byte,
                                                torch.from_numpy(table), c)
        wire, last = bpe_cuda.pack_slots_plain(slots, n, p)
        assert np.array_equal(got[0], wire.numpy()), (n, carry, prev, next_byte)
        assert (got[1], got[2]) == (int(c_out), int(last)), (n, carry, prev, next_byte)
        want = (wire, c_out, last)
        wrapped = bpe_cuda.flat_encode_packed(torch.from_numpy(data), n, next_byte,
                                              torch.from_numpy(table), c, p)
        assert all(torch.equal(a, b) for a, b in zip(wrapped, want))


def test_fused_pass_starts_on_tile_edges_and_reads_prev_slot():
    """The cases the mirror is there for, checked in the plain wire itself:
    a merge starting on a tile's last position flags it and the next
    tile's first byte, which carry the merge's two bytes; a prev_slot that
    is a start consumes byte 0."""
    rng = np.random.default_rng(5)
    cap = 4 * 64
    table = _flat_table(rng)
    data = _flat_data(rng, cap, 64)
    data[0] = 32  # no rule starts with a space: byte 0 is no start itself
    c = torch.zeros((1, 1), dtype=torch.int32)
    wire, _, _ = bpe_cuda.flat_packed_plain(torch.from_numpy(data), cap, -1,
                                            torch.from_numpy(table), c,
                                            torch.tensor(0x0161, dtype=torch.int32))
    flags = np.unpackbits(wire[cap:].numpy(), bitorder="little").astype(bool)
    slot = int(table[97 * 256 + 98])  # (97, 98)'s value, byteswapped
    for edge in range(64, cap, 64):
        assert flags[edge - 1] and flags[edge]  # the start and the byte it consumes
        assert (int(wire[edge - 1]), int(wire[edge])) == (slot & 0xFF, slot >> 8)
    assert flags[0] and wire[0] == 0x01  # byte 0 consumed by prev_slot's merge 0x0161


def test_fused_pass_counts_no_launch_on_the_cpu_and_checks_its_state():
    data = torch.zeros(4096, dtype=torch.uint8)
    table = torch.from_numpy(_flat_table(np.random.default_rng(0)))
    c = torch.zeros((1, 1), dtype=torch.int32)
    bpe_cuda.reset_launches()
    multipass_cuda.reset_launches()
    bpe_cuda.flat_encode_packed(data, 100, -1, table, c, torch.zeros((), dtype=torch.int32))
    multipass_cuda.token_pass(torch.zeros(4096, dtype=torch.int32), 100,
                              cuckoo_planes(MergeTable.build(HIER), CPU), multipass_cuda.K4_FLAGS)
    assert all(v == 0 for v in bpe_cuda.launches.values())
    assert all(v == 0 for v in multipass_cuda.launches.values())
    with pytest.raises(ValueError, match="one prev slot"):
        bpe_cuda.flat_encode_packed(data, 100, -1, table, c, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA or all-CPU"):
        bpe_cuda.flat_encode_packed(data, 100, -1, table, c,
                                    torch.zeros((), dtype=torch.int32, device="meta"))


def test_exp_lookback_pack_row_chains_through_the_last_slot():
    """``exp_lookback.pack_row``: K2's standalone pack over every slot,
    chained k times, each pass taking the last slot the one before
    returned; its bound is 2 bytes in and 1.125 out a slot and two words."""
    from blt_tpu_torch.tools import exp_lookback

    data = torch.from_numpy(np.frombuffer(b"ab c abca" * 1000, np.uint8)[:8192].copy())
    data[-1] = ord("z")  # a last slot that is a plain byte, not 0
    table = wire_table(MergeTable.build(FLAT).dense, CPU)
    slots, _ = bpe_cuda.flat_encode_slots(data, 8192, -1, table,
                                          torch.zeros((1, 1), dtype=torch.int32))
    row = exp_lookback.pack_row(slots, k=3)
    assert row["name"] == "pack" and row["slots"] == 8192 and row["exact"]
    assert row["graph"] is None and row["eager"]["ms_per_launch"]["n"] == 5
    assert row["bound_ms"] == pytest.approx((2 + 1 + 1 / 8) * 8192 / 3.35e9 + 8 / 3.35e9)
    # a chain's passes after the first start from the last slot
    zero = torch.zeros((), dtype=torch.int32)
    last = slots[-1].to(torch.int32)
    assert int(last) != 0
    for k, prev in ((1, zero), (3, last)):
        wire, got = exp_lookback.pack_chain(slots, k, bpe_cuda.pack_slots_plain)
        ref = bpe_cuda.pack_slots_plain(slots, 8192, prev)
        assert torch.equal(wire, ref[0]) and int(got) == int(last) == int(ref[1])
