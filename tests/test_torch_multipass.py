"""General-table (multipass) BPE of the torch port against the JAX package,
on the CPU.

On the CPU the port's wrappers run their kernels' plain PyTorch versions
(``token_pass_plain``, ``token_pass_gap_plain``); the JAX side runs the
Pallas token passes in interpret mode at 8 rows per block (1024 positions),
so a 4096-token buffer spans four Pallas blocks and exercises the block
carry. Every comparison is exact (tolerance 0): every value is an integer
token, count or wire byte. Inputs come from numpy ``default_rng(seed)``.
The CUDA kernels themselves are held against the plain versions by
tests/test_torch_gpu.py and by ``chip_smoke.py``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_tpu.config import CoreConfig as JaxCoreConfig
from blt_tpu.config import Engine as JaxEngineName
from blt_tpu.merges import MergeTable as JaxMergeTable
from blt_tpu.ops import bpe_jax
from blt_tpu.ops import bpe_pallas as bp
from blt_tpu.ops.bpe_numpy import bpe_encode_multipass
from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
from blt_tpu.pipeline.engines import JaxEngine
from blt_tpu.pipeline.engines import NumpyEngine as JaxNumpyEngine
from blt_tpu.pipeline.runner import run_tokenizer as jax_run_tokenizer
from blt_tpu_torch.api import ByteTokenizer
from blt_tpu_torch.config import CoreConfig
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import bpe_torch, multipass_cuda, tables
from blt_tpu_torch.ops.multipass_cuda import (
    CudaTokenEncoder,
    expand_gap_wire_host,
    token_pass,
    token_pass_gap,
    token_pass_gap_plain,
    token_pass_plain,
)
from blt_tpu_torch.ops.tables import cuckoo32_placement, cuckoo_planes, planes_from_jax
from blt_tpu_torch.pipeline import feeder, runner
from blt_tpu_torch.pipeline.engines import NumpyEngine, ShardedTorchEngine, TorchEngine
from blt_tpu_torch.pipeline.runner import run_tokenizer
from h100_bench.common import recipes
from h100_bench.reference import bpe as bench_bpe
from h100_bench.tables import learned

RPB = 8  # Pallas rows per block: 1024-token blocks
CAP = 4096
CPU = torch.device("cpu")

HIER = {(97, 98): 256, (256, 99): 257, (257, 257): 300,
        (120, 121): 90, (90, 122): 0, (0, 97): 400}
# tokens >= 32768 and 0xFFFF: d * 65536 wraps int32 in the key and the hash
HIGH = {(0xFFFF, 97): 40000, (40000, 0xFFFF): 0xFFFF, (97, 0xFFFF): 32768,
        (32768, 32768): 50000, (97, 98): 256, (256, 256): 0xFFFE}
CHAIN = {(97, 97): 256, (256, 256): 257, (257, 257): 258, (258, 258): 259}


def _big_table_merges(seed=3, n=7000):
    """Random rules over tokens 0..599, placed by cuckoo32 at 8192 slots."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(600 * 600)[:n]
    return {(int(k) // 600, int(k) % 600): 600 + i for i, k in enumerate(keys)}


TABLES = {"hier": HIER, "high": HIGH, "chain": CHAIN, "big": _big_table_merges()}


def _alphabet(merges):
    members = sorted({x for pair in merges for x in pair} | set(merges.values()))
    return np.array(members + [97, 98, 99], np.int32)


def _jax_planes(merges):
    k1, v1, k2, v2, a1, a2 = JaxMergeTable.build(merges).build_cuckoo32()
    shift = 32 - (k1.shape[0].bit_length() - 1)
    planes = [jnp.asarray(x.reshape(-1, 128)) for x in (k1, v1, k2, v2)]
    return planes, (a1, a2, shift)


def _port_planes(merges):
    planes = cuckoo_planes(MergeTable.build(merges), CPU)
    assert planes is not None
    return planes


def _pallas_token_pass(merges, toks, n):
    planes, (a1, a2, shift) = _jax_planes(merges)
    buf = np.zeros(toks.shape[0] + 8 * 128, np.int32)  # + the 8 halo rows
    buf[: toks.shape[0]] = toks
    params = jnp.asarray(np.array([n, a1, a2, shift, 0, 0, 0, 0], np.int32))
    out = bp._token_pass_call(params, jnp.asarray(buf.reshape(-1, 128)), *planes,
                              interpret=True, rows_per_block=RPB)
    return np.asarray(out).reshape(-1)


def _pallas_gap_pass(merges, toks):
    planes, (a1, a2, shift) = _jax_planes(merges)
    params = jnp.asarray(np.array([0, a1, a2, shift, 0, 0, 0, 0], np.int32))
    out, counts = bp._token_pass_gap_call(
        params, jnp.asarray(toks.reshape(-1, 128)), *planes,
        interpret=True, rows_per_block=RPB,
    )
    return np.asarray(out).reshape(-1), int(np.asarray(counts).sum())


# --- K4 ---------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TABLES))
def test_token_pass_plain_equals_pallas(name):
    merges = TABLES[name]
    rng = np.random.default_rng(1)
    planes = _port_planes(merges)
    toks = rng.choice(_alphabet(merges), CAP).astype(np.int32)
    toks[1000:1100] = 97  # a match run across nothing in CHAIN, parity
    toks[2000:2200] = 97  # ...and one across a Pallas block edge (2048)
    for n in (0, 1, 2, 3, 1023, 1025, 3001, CAP):
        got = token_pass_plain(torch.from_numpy(toks.copy()), n, planes)
        assert got.dtype == torch.int32 and tuple(got.shape) == (CAP,)
        # the whole buffer: past n both return the token unchanged
        assert np.array_equal(got.numpy(), _pallas_token_pass(merges, toks, n)), (name, n)


# --- K3 ---------------------------------------------------------------------


def _tombstoned(rng, alphabet, max_run):
    """Random tokens with tombstone runs of 1..max_run, -1 padding at the end."""
    toks = rng.choice(alphabet, CAP).astype(np.int32)
    i = int(rng.integers(0, 8))
    while i < CAP:
        run = int(rng.integers(1, max_run + 1))
        toks[i : i + run] = -1
        i += run + int(rng.integers(1, 12))
    toks[CAP - int(rng.integers(0, 300)) :] = -1
    return toks


@pytest.mark.parametrize("max_run", [1, 3, 4, 7])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_token_pass_gap_plain_equals_pallas(name, max_run):
    """Random tombstone patterns, including runs of 4 and more, which break
    a pair (the look-ahead is four positions): tokens and the alive count."""
    merges = TABLES[name]
    rng = np.random.default_rng(max_run)
    planes = _port_planes(merges)
    for case in range(2):
        toks = _tombstoned(rng, _alphabet(merges), max_run)
        if case:
            toks[1020:1030] = [97, -1, -1, -1, 97, -1, -1, -1, -1, 97]  # across a block edge
        got, count = token_pass_gap_plain(torch.from_numpy(toks), planes)
        ref, ref_count = _pallas_gap_pass(merges, toks)
        assert np.array_equal(got.numpy(), ref), (name, max_run, case)
        assert int(count) == ref_count == int((got >= 0).sum())


def test_token_pass_gap_edges():
    """Empty, one token, two tokens, and all-padding buffers."""
    planes = _port_planes(CHAIN)
    for alive in (0, 1, 2, 5):
        toks = np.full(CAP, -1, np.int32)
        toks[:alive] = 97
        got, count = token_pass_gap_plain(torch.from_numpy(toks), planes)
        ref, ref_count = _pallas_gap_pass(CHAIN, toks)
        assert np.array_equal(got.numpy(), ref) and int(count) == ref_count


# --- K3's look-back (token_pass_gap.cu), mirrored on the host --------------

GAP_TILE = 4096  # positions per CTA in token_pass_gap.cu
IDENTITY, FLIP, RESET = 2, 3, 0  # the codes x -> a ^ (b & x), as a | b << 1


def _compose(later, earlier):
    return ((later ^ ((later >> 1) & earlier)) & 1) | (later & earlier & 2)


def _apply(f, x):
    return (f & 1) ^ ((f >> 1) & x)


def _gap_codes(toks, planes):
    """Each position's (code, value): identity where dead, flip where the
    pair with the next alive token (of the next four) has a rule, else
    reset."""
    d = torch.from_numpy(toks)
    nxt = torch.full_like(d, -1)
    for k in range(multipass_cuda.GAP_LOOKAHEAD, 0, -1):
        t = torch.full_like(d, -1)
        t[:-k] = d[k:]
        nxt = torch.where(t >= 0, t, nxt)
    hit, val = multipass_cuda._lookup(d, nxt, planes)
    alive = d >= 0
    code = torch.where(~alive, IDENTITY, torch.where(hit & (nxt >= 0), FLIP, RESET))
    return code.numpy(), val.numpy()


def _tile_codes(code):
    """Each tile's code: its positions' codes composed in order."""
    out = []
    for t in range(0, code.shape[0], GAP_TILE):
        f = IDENTITY
        for c in code[t : t + GAP_TILE]:
            f = _compose(int(c), f)
        out.append(f)
    return out


def _look_back(aggs, rng):
    """Each tile's entering state by the kernel's protocol, the tiles'
    steps interleaved in the order ``rng`` draws: a tile publishes its
    status (a prefix at once where its code is constant, else its code as
    an aggregate; tile 0 nothing yet), then reads its predecessors' words
    nearest first, one read per step, waiting at an unpublished one and
    composing aggregates until a prefix (or past tile 0: state 0), then
    publishes its own prefix where it had not."""
    status = [None] * len(aggs)  # ("aggregate", code) or ("prefix", state)
    entering = [None] * len(aggs)

    def tile(t):
        agg = aggs[t]
        reset = not agg & 2
        if reset:
            status[t] = ("prefix", _apply(agg, 0))
        elif t > 0:
            status[t] = ("aggregate", agg)
        yield
        f, state = IDENTITY, 0
        for j in range(t - 1, -1, -1):
            while status[j] is None:
                yield
            kind, value = status[j]
            if kind == "prefix":
                state = value
                break
            f = _compose(f, value)
            yield
        entering[t] = _apply(f, state)
        if not reset:
            status[t] = ("prefix", _apply(agg, entering[t]))

    running = {t: tile(t) for t in range(len(aggs))}
    while running:
        t = list(running)[int(rng.integers(len(running)))]
        if next(running[t], "done") == "done":
            del running[t]
    return entering


def _emit(toks, code, val, entering):
    """Each tile emits from its entering state: (tokens, alive count)."""
    out = np.full_like(toks, -1)
    for t, state in enumerate(entering):
        for i in range(t * GAP_TILE, min((t + 1) * GAP_TILE, toks.shape[0])):
            if code[i] == IDENTITY:
                continue
            start = code[i] == FLIP and not state
            out[i] = -1 if state else (val[i] if start else toks[i])
            state = int(start)
    return out, int((out >= 0).sum())


def _look_back_cases(rng):
    """(name, merges, tokens over 6 tiles): dead tiles between live ones,
    one match run over every tile, random pairs, tombstone runs."""
    cap = 6 * GAP_TILE
    dead = np.full(cap, -1, np.int32)
    dead[:50] = 97
    dead[4 * GAP_TILE + 7 : 4 * GAP_TILE + 90] = 97  # tiles 1-3 all dead
    flips = np.full(cap, 97, np.int32)  # every pair of CHAIN matches
    flips[3 * GAP_TILE + 5] = -1  # tile 3: 4095 flips compose to a flip
    flips[-1] = -1
    hier = rng.choice(_alphabet(HIER), cap).astype(np.int32)
    runs = hier.copy()
    for edge in range(GAP_TILE, cap, GAP_TILE):
        runs[edge - 3 : edge + 2] = -1  # a run of 5 over each tile edge
    runs[100:5000:9] = -1
    return [("identity", CHAIN, dead), ("flip", CHAIN, flips), ("reset", HIER, hier),
            ("tombstones", HIER, runs)]


@pytest.mark.parametrize("case", range(4))
def test_look_back_gives_the_sequential_prefix(case):
    """Tiles publish in random orders; each tile's walk gives the state the
    sequential composition of the tiles before it gives, and emitting from
    it gives token_pass_gap_plain and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(case)
    name, merges, toks = _look_back_cases(rng)[case]
    planes = _port_planes(merges)
    code, val = _gap_codes(toks, planes)
    aggs = _tile_codes(code)
    if name == "identity":
        assert aggs[1:4] == [IDENTITY] * 3
    if name == "flip":
        # 4096 flips compose to the identity, tile 3's 4095 to a flip
        assert aggs[:-1] == [IDENTITY] * 3 + [FLIP, IDENTITY]
    if name == "reset":
        assert all(not a & 2 for a in aggs)  # every tile holds a reset
    sequential = [0]
    for a in aggs[:-1]:
        sequential.append(_apply(a, sequential[-1]))
    for order in range(3):
        assert _look_back(aggs, np.random.default_rng(100 + order)) == sequential
    out, count = _emit(toks, code, val, sequential)
    got, got_count = token_pass_gap_plain(torch.from_numpy(toks), planes)
    assert np.array_equal(out, got.numpy()) and count == int(got_count)
    ref, ref_count = _pallas_gap_pass(merges, toks)
    assert np.array_equal(out, ref) and count == ref_count


def test_exp_gap_table_and_rounds_on_the_cpu():
    """exp_gap's table is leg 4's (8000 rules, later ones over merged
    tokens, placed at 8192 slots), and its row times rounds that each take
    the last one's tokens."""
    from blt_tpu_torch.tools import _common, exp_gap, exp_mp_ablate

    corpus = _common.make_corpus(np.random.default_rng(0), 4 << 20)
    rules = exp_gap.hierarchical_rules(corpus)
    assert len(rules) == 8000 and max(max(p) for p in rules) >= 256
    planes = cuckoo_planes(MergeTable.build(rules), CPU)
    assert planes.slots == 8192
    toks = torch.from_numpy(corpus[:CAP].astype(np.int32))
    out, count = exp_mp_ablate.feed_back(lambda t: token_pass_gap(t, planes), toks, 2)
    once, _ = token_pass_gap_plain(toks, planes)
    assert torch.equal(out, token_pass_gap_plain(once, planes)[0])
    assert int(count) == int((out >= 0).sum()) < CAP
    row = exp_gap.gap_row(toks, planes, k=2)
    assert row["exact"] and row["graph"] is None and row["bound_by"] == "bytes"


def test_wrappers_dispatch_on_the_tensor_device_only():
    planes = _port_planes(HIER)
    toks = torch.full((CAP,), 97, dtype=torch.int32)
    multipass_cuda.reset_launches()
    token_pass(toks, CAP, planes)
    token_pass_gap(toks, planes)
    assert multipass_cuda.launches == dict.fromkeys(
        ["token_pass_gap", *multipass_cuda.TOKEN_PASSES], 0)
    with pytest.raises(ValueError, match="int32"):
        token_pass(toks.to(torch.int64), CAP, planes)
    with pytest.raises(ValueError, match="do not fit"):
        token_pass(toks, CAP + 1, planes)
    with pytest.raises(ValueError, match="CUDA or all-CPU"):
        token_pass_gap(toks.to("meta"), planes)


# --- the encoder ------------------------------------------------------------


def _encoders(merges, capacity=CAP):
    jax_enc = bp.PallasTokenEncoder(JaxMergeTable.build(merges), interpret=True,
                                    capacity_tokens=capacity, rows_per_block=RPB)
    port = CudaTokenEncoder(MergeTable.build(merges), CPU, capacity_tokens=capacity)
    return jax_enc, port


def _bytes(rng, n, alphabet=b"abcabcxyzaxyz"):
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


@pytest.mark.parametrize("name", ["hier", "chain"])
def test_encoder_encode_and_encode_pass_equal_pallas(name):
    merges = TABLES[name]
    jax_enc, port = _encoders(merges)
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 777, CAP):
        data = _bytes(rng, n, b"aaaab" if name == "chain" else b"abcabcxyzaxyz")
        toks = data.astype(np.int32)
        assert np.array_equal(port.encode_pass(toks), jax_enc.encode_pass(toks))
        got = port.encode(data)
        assert got.tolist() == jax_enc.encode(data).tolist()
        assert got.tolist() == bpe_encode_multipass(data, JaxMergeTable.build(merges)).tolist()


@pytest.mark.parametrize("mode", ["gap", "sort"])
def test_encode_resident_equals_pallas(mode, monkeypatch):
    monkeypatch.setenv("BLT_MP_COMPACT", mode)
    jax_enc, port = _encoders(HIER)
    rng = np.random.default_rng(7)
    multipass_cuda.reset_launches()
    for n in (0, 1, 2, 777, CAP):
        data = _bytes(rng, n)
        got = port.encode_resident(data)
        assert got.tolist() == jax_enc.encode_resident(data).tolist(), (mode, n)
        assert got.tolist() == bpe_encode_multipass(data, JaxMergeTable.build(HIER)).tolist()
    toks, m = port.encode_resident_dispatch(_bytes(rng, CAP))
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (CAP,) and int(m) > 0
    # every dispatch logged its rounds; the gap loop compacts at most every
    # third round, the sort loop after every round
    assert len(multipass_cuda.loop_log) == 4
    for rounds, compactions in multipass_cuda.loop_log:
        assert rounds >= 1
        assert compactions == rounds if mode == "sort" else compactions <= rounds // 3


def test_resident_gap_tokens_and_wire_equal_pallas():
    """The gap loop's tombstoned buffer, its count and the wire, whole."""
    jax_enc, port = _encoders(CHAIN)
    rng = np.random.default_rng(9)
    for data in (np.full(CAP - 5, 97, np.uint8), _bytes(rng, 3000, b"aaab"),
                 np.zeros(0, np.uint8)):
        j_toks, j_m = jax_enc.encode_resident_dispatch(data)
        p_toks, p_m = port.encode_resident_dispatch(data)
        assert np.array_equal(p_toks.numpy(), np.asarray(j_toks)) and int(p_m) == int(j_m)
        j_wire, j_m, j_cap = jax_enc.encode_resident_wire_dispatch(data)
        p_wire, p_m, p_cap = port.encode_resident_wire_dispatch(data)
        assert p_cap == j_cap == CAP and p_wire.dtype == torch.uint8
        assert np.array_equal(p_wire.numpy(), np.asarray(j_wire))
        expanded = expand_gap_wire_host(p_wire.numpy(), p_cap)
        assert expanded.shape[0] == int(p_m)
        assert np.array_equal(expanded, bp.expand_gap_wire_host(np.asarray(j_wire), j_cap))


def test_planes_from_jax_continues_a_jax_encoder():
    """Rounds started by the JAX encoder and finished by the port on the
    JAX encoder's own planes equal a run done entirely in either."""
    jax_enc, port = _encoders(HIGH)
    planes = planes_from_jax(np.asarray(jax_enc.k1), np.asarray(jax_enc.v1),
                             np.asarray(jax_enc.k2), np.asarray(jax_enc.v2),
                             jax_enc.a1, jax_enc.a2)
    assert planes.shift == jax_enc.shift and planes.slots == jax_enc.k1.size
    assert all(p.dtype == torch.int32 for p in (planes.k1, planes.v1, planes.k2, planes.v2))
    rng = np.random.default_rng(11)
    data = rng.choice(_alphabet(HIGH), 3000).astype(np.int32)
    out = jax_enc.encode_pass(data)  # round 1 on the JAX side
    toks = out[out != -1]
    while True:  # the rest through the port's K4 on the carried planes
        out = token_pass_plain(torch.from_numpy(toks), toks.shape[0], planes).numpy()
        kept = out[out != -1]
        if kept.shape[0] == toks.shape[0]:
            break
        toks = kept
    assert toks.tolist() == jax_enc.encode(data).tolist() == port.encode(data).tolist()
    with pytest.raises(ValueError, match="power-of-two"):
        planes_from_jax(np.zeros(100, np.int32), np.zeros(100, np.int32),
                        np.zeros(100, np.int32), np.zeros(100, np.int32), 1, 1)


# --- bpe_torch.multipass_encode (the twin) ----------------------------------


@pytest.mark.parametrize("name", ["hier", "high", "chain"])
def test_bpe_torch_multipass_equals_bpe_jax(name):
    merges = TABLES[name]
    jt = JaxMergeTable.build(merges)
    keys_j, vals_j = bpe_jax.sparse_table_device(jt)
    keys_t, vals_t = bpe_torch.sparse_table_device(MergeTable.build(merges))
    rng = np.random.default_rng(13)
    buf = _bytes(rng, 2048, b"aaabcxyz")
    for length in (0, 1, 2, 1500, 2048):
        j_toks, j_len = bpe_jax.multipass_encode(jnp.asarray(buf), jnp.int32(length), keys_j, vals_j)
        t_toks, t_len = bpe_torch.multipass_encode(torch.from_numpy(buf.copy()), length, keys_t, vals_t)
        assert np.array_equal(t_toks.numpy(), np.asarray(j_toks)), (name, length)
        assert int(t_len) == int(j_len)
    empty = bpe_torch.sparse_table_device(MergeTable.build({}))
    assert empty[0].tolist() == [0xFFFFFFFF] and empty[1].tolist() == [-1]


# --- the engine and the runner ----------------------------------------------

HINT = 4096


def _join(results) -> bytes:
    return b"".join(bytes(memoryview(r).cast("B")) for r in results)


def _chunks(data, size):
    return [data[i : i + size] for i in range(0, data.shape[0], size)]


@pytest.mark.parametrize("mode", ["gap", "sort", "twin"])
@pytest.mark.parametrize("name", ["hier", "chain"])
def test_torch_engine_multipass_stream_equals_jax_numpy_and_oracle(name, mode, monkeypatch):
    if mode == "twin":
        monkeypatch.setenv("BLT_MULTIPASS", "xla")
    else:
        monkeypatch.setenv("BLT_MP_COMPACT", mode)
    merges = TABLES[name]
    rng = np.random.default_rng(17)
    data = _bytes(rng, 3 * HINT + 77, b"aaaab" if name == "chain" else b"abcabcxyzaxyz")
    chunks = _chunks(data, HINT)
    multipass_cuda.reset_launches()
    feeder.stage_stats(reset=True)
    port = _join(TorchEngine(CPU, depth=2).bpe_stream(iter(chunks), MergeTable.build(merges), HINT))
    # the route taken: one loop a chunk, each counted under its route alone
    taken, other = ("mp.twin", "mp.loop") if mode == "twin" else ("mp.loop", "mp.twin")
    stats = feeder.stage_stats()
    assert stats[taken]["items"] == len(multipass_cuda.loop_log) == len(chunks)
    assert other not in stats
    jt = JaxMergeTable.build(merges)
    jax_out = _join(JaxEngine().bpe_stream(iter(chunks), jt, HINT))
    host = _join(NumpyEngine(1).bpe_stream(iter(chunks), MergeTable.build(merges), HINT))
    jax_host = _join(JaxNumpyEngine(1).bpe_stream(iter(chunks), jt, HINT))
    oracle = b"".join(tokens_to_be_bytes(bpe_encode_oracle(c.tobytes(), merges)) for c in chunks)
    assert port == jax_out == host == jax_host == oracle


def test_engine_routes_by_table_never_by_failure(monkeypatch):
    """The table chooses the route. 9000 rules, more than the default 8192
    slots place, take the kernel loop on the wide placement's 16,384
    slots; 52,429 rules, more than 65,536 slots hold at 0.8 a slot, take
    the twin, refused at once: the only placement tried is the default
    one, which refuses more rules than its 8192 slots before any seed. A
    chunk longer than the capacity is never cut."""
    wide = MergeTable.build(_big_table_merges(seed=4, n=9000))
    assert CudaTokenEncoder.supports(wide)
    assert cuckoo_planes(wide).slots == 16384
    assert CudaTokenEncoder.supports(MergeTable.build(TABLES["big"]))
    assert cuckoo_planes(MergeTable.build(TABLES["big"])).slots == 8192
    table = MergeTable.build(_big_table_merges(seed=4, n=52_429))
    tried = []
    impl = MergeTable._build_cuckoo32_impl

    def spy(self, slots=None, max_seed_tries=64):
        tried.append(slots)
        return impl(self, slots, max_seed_tries)

    monkeypatch.setattr(MergeTable, "_build_cuckoo32_impl", spy)
    assert not CudaTokenEncoder.supports(table)
    assert tables.wide_cuckoo_slots(len(table)) is None and tried == [None]
    monkeypatch.undo()
    rng = np.random.default_rng(19)
    data = rng.integers(0, 600, 2 * HINT).astype(np.uint8)
    chunks = _chunks(data, HINT)
    for t, taken, other in ((wide, "mp.loop", "mp.twin"), (table, "mp.twin", "mp.loop")):
        multipass_cuda.reset_launches()
        feeder.stage_stats(reset=True)
        got = _join(TorchEngine(CPU).bpe_stream(iter(chunks), t, HINT))
        stats = feeder.stage_stats()  # one loop a chunk, on the table's route alone
        assert stats[taken]["items"] == len(chunks) and other not in stats
        assert got == b"".join(bpe_encode_multipass(c, t).astype(">u2").tobytes()
                               for c in chunks)
    with pytest.raises(ValueError, match="never cut"):
        _join(TorchEngine(CPU).bpe_stream(iter([data]), MergeTable.build(HIER), HINT))
    with pytest.raises(ValueError, match="placement failed"):
        CudaTokenEncoder(table, CPU)


# --- the wide cuckoo32 placement ---------------------------------------------


@pytest.mark.parametrize("n,slots", [(8192, 8192), (8193, 16384), (9000, 16384),
                                     (50_000, 65536), (52_428, 65536), (52_429, None)])
def test_placement_slots_by_rule_count(n, slots):
    """Up to 8192 rules the default placement, the JAX package's; past it
    the wide one at the smallest power of two from 16,384 that holds the
    rules at 0.8 a slot; past 65,536 slots none, refused before any seed."""
    table = MergeTable.build(_big_table_merges(seed=5, n=n))
    placed = cuckoo_planes(table, CPU)
    assert (None if placed is None else placed.slots) == slots
    assert (table.build_cuckoo32() is not None) == (n <= 8192)
    assert tables.wide_cuckoo_slots(n) == (None if n > 52_428 else max(slots, 16384))
    assert CudaTokenEncoder.supports(table) == (slots is not None)


@pytest.mark.parametrize("n", [9000, 50_000])
def test_wide_planes_hold_every_rule_and_no_other_pair(n):
    """``_lookup`` over the wide planes finds every rule's value, and no
    pair the table lacks (tokens 0..599 and 0xFFFF, which wraps the key)."""
    merges = _big_table_merges(seed=6, n=n)
    planes = cuckoo_planes(MergeTable.build(merges), CPU)
    assert planes.slots > 8192
    keys = np.array(list(merges), np.int32)
    hit, val = multipass_cuda._lookup(torch.from_numpy(keys[:, 0]),
                                      torch.from_numpy(keys[:, 1]), planes)
    assert bool(hit.all()) and val.tolist() == list(merges.values())
    rng = np.random.default_rng(7)
    pairs = np.concatenate([rng.integers(0, 600, (20_000, 2)),
                            [[0xFFFF, 97], [97, 0xFFFF], [0xFFFF, 0xFFFF]]]).astype(np.int32)
    absent = np.array([(int(a), int(b)) not in merges for a, b in pairs])
    hit, _ = multipass_cuda._lookup(torch.from_numpy(pairs[absent, 0]),
                                    torch.from_numpy(pairs[absent, 1]), planes)
    assert absent.sum() > 10_000 and not bool(hit.any())


def test_wide_placement_is_memoized_and_counted_once():
    """The wide build is cached on the table, and ``cuckoo.wide`` counts one
    placement (its four planes' bytes) over a stream's ``supports`` and
    each of its three rows' ``__init__``; the default build stays None."""
    table = MergeTable.build(_big_table_merges(seed=8, n=9000))
    feeder.stage_stats(reset=True)
    eng = ShardedTorchEngine([CPU] * 3)
    data = np.random.default_rng(9).integers(0, 600, 3 * HINT).astype(np.uint8)
    got = _join(eng.bpe_stream(iter(_chunks(data, HINT)), table, HINT))
    assert got == b"".join(bpe_encode_multipass(c, table).astype(">u2").tobytes()
                           for c in _chunks(data, HINT))
    built = cuckoo32_placement(table)
    assert cuckoo32_placement(table) is built and cuckoo_planes(table, CPU).slots == 16384
    assert built[0].shape == (16384,) and table.build_cuckoo32() is None
    stats = feeder.stage_stats(reset=True)
    assert (stats["cuckoo.wide"]["items"], stats["cuckoo.wide"]["bytes"]) == (1, 4 * 4 * 16384)
    assert stats["mp.loop"]["items"] == 3


def test_run_tokenizer_general_table_equals_jax_runner(tmp_path):
    """The port's runner with config.with_merges: three 256 KiB chunks, each
    encoded on its own, through TorchEngine on the CPU."""
    rng = np.random.default_rng(23)
    src = tmp_path / "in.bin"
    src.write_bytes(_bytes(rng, 600_000).tobytes())
    outs = {}
    for side, make, run, engine in (
        ("port", CoreConfig, run_tokenizer, TorchEngine(CPU)),
        ("jax", JaxCoreConfig, jax_run_tokenizer, None),
    ):
        out = tmp_path / f"{side}.bin"
        config = make.new_from_cli(input=src, output=out, chunksize="256KB").with_merges(HIER)
        if engine is None:
            config.engine = JaxEngineName.NUMPY
            run(config)
        else:
            run(config, engine=engine)
        outs[side] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    data = np.frombuffer(src.read_bytes(), np.uint8)
    expected = b"".join(
        bpe_encode_multipass(c, JaxMergeTable.build(HIER)).astype(">u2").tobytes()
        for c in _chunks(data, 256 * 1024)
    )
    assert outs["port"] == expected


# --- a learned table of more than 8192 rules: the kernel loop and the twin --

# chunk sizes cycled over the input: a stream of 1, 4 or 64 KiB chunks, and
# one of ragged chunks with 1-byte and empty ones among them
LEARNED_CHUNKS = {"1k": (1024,), "4k": (4096,), "64k": (65536,),
                  "ragged": (1, 3000, 0, 65536, 1, 777)}


@pytest.fixture(scope="module")
def learned_rules():
    """The benchmark's learned recipe at a 256 KiB sample: 9000 rules on
    merged tokens, more than cuckoo32's default 8192 slots place."""
    rules = learned.build({"rules": 9000, "per_round": 500, "sample_bytes": 256 << 10},
                          11, CPU).rules
    table = MergeTable.build(rules)
    assert not table.flat and table.build_cuckoo32() is None
    return rules


def _cut(data, sizes):
    out, i = [], 0
    for size in itertools.cycle(sizes):
        if i >= data.shape[0]:
            return out
        out.append(data[i : i + size])
        i += size


def _reference(rules, chunks) -> bytes:
    """The benchmark's plain reference, chunk by chunk, as u16-BE."""
    keys, vals = bench_bpe.rule_tensors(rules, CPU)
    return b"".join(t.numpy().astype(">u2").tobytes() for c in chunks
                    for t in bench_bpe.chunked_multipass(c, keys, vals, max(c.shape[0], 1)))


def _learned_stream(rules, cut, engine, route):
    """The learned table's stream on one CPU device or three CPU rows
    (chunk i on row i % 3): each chunk's tokens are the JAX package's
    oracle's and the benchmark's plain reference's; every non-empty chunk
    is one loop, counted under ``mp.<route>`` alone."""
    sizes = LEARNED_CHUNKS[cut]
    data = recipes.text_corpus(29, 150_000)
    chunks = _cut(data, sizes)
    eng = TorchEngine(CPU, depth=2) if engine == "torch" else ShardedTorchEngine([CPU] * 3)
    multipass_cuda.reset_launches()
    feeder.stage_stats(reset=True)
    got = _join(eng.bpe_stream(iter(chunks), MergeTable.build(rules), max(sizes)))
    oracle = b"".join(tokens_to_be_bytes(bpe_encode_oracle(c.tobytes(), rules))
                      for c in chunks)
    assert got == oracle == _reference(rules, chunks)
    live = [c for c in chunks if c.shape[0]]
    assert len(multipass_cuda.loop_log) == len(live)
    stats = feeder.stage_stats()
    taken = f"mp.{route}"
    assert (stats[taken]["items"], stats[taken]["bytes"]) == (len(live), data.shape[0])
    assert stats["mp.passes"]["items"] == sum(p for p, _ in multipass_cuda.loop_log)
    assert {"feed", "d2h", "drain"} <= set(stats)
    return stats


@pytest.mark.parametrize("engine", ["torch", "shard"])
@pytest.mark.parametrize("cut", list(LEARNED_CHUNKS))
def test_staged_twin_on_a_learned_table_equals_reference_and_oracle(
        learned_rules, cut, engine, monkeypatch):
    """The twin route on its stages, forced by ``BLT_MULTIPASS=xla``: no
    kernel loop and no wide placement."""
    monkeypatch.setenv("BLT_MULTIPASS", "xla")
    stats = _learned_stream(learned_rules, cut, engine, "twin")
    assert "mp.loop" not in stats and "cuckoo.wide" not in stats


@pytest.mark.parametrize("engine", ["torch", "shard"])
@pytest.mark.parametrize("cut", list(LEARNED_CHUNKS))
@pytest.mark.parametrize("compact", ["gap", "sort"])
def test_kernel_loop_on_a_learned_table_equals_reference_and_oracle(
        learned_rules, cut, engine, compact, monkeypatch):
    """The engine's own choice for the table, under each
    ``BLT_MP_COMPACT``: the K3 loop (``gap``) or the K4 loop (``sort``) on
    the wide placement's 16,384 slots, placed once for the whole stream,
    whatever its rows. On CPU rows each round is the wrapper's plain
    version over the wide planes; every round the loops count is one call
    of that loop's round, ``token_pass_gap`` or ``token_pass``, and none
    of the other's."""
    monkeypatch.setenv("BLT_MP_COMPACT", compact)
    calls = {"token_pass_gap": 0, "token_pass": 0}
    for name in calls:
        def spy(*args, _round=getattr(multipass_cuda, name), _name=name):
            calls[_name] += 1
            return _round(*args)
        monkeypatch.setattr(multipass_cuda, name, spy)
    stats = _learned_stream(learned_rules, cut, engine, "loop")
    assert "mp.twin" not in stats
    assert (stats["cuckoo.wide"]["items"], stats["cuckoo.wide"]["bytes"]) == (1, 16 * 16384)
    rounds = sum(r for r, _ in multipass_cuda.loop_log)
    taken, other = "token_pass_gap", "token_pass"
    if compact == "sort":
        taken, other = other, taken
    assert calls[taken] == rounds > 0 and calls[other] == 0
    if compact == "sort":  # K4's loop compacts after every round
        assert all(r == c for r, c in multipass_cuda.loop_log)


@pytest.mark.parametrize("size", [600_000, 1, 0])
def test_tokenize_file_on_a_learned_table(learned_rules, size, tmp_path, monkeypatch):
    """``ByteTokenizer.tokenize_file`` down the engine's own route choice,
    on a CPU ``TorchEngine``: three 256 KiB chunks, a 1-byte file and an
    empty one, each the header then the JAX package's oracle's and the
    benchmark's plain reference's tokens."""
    monkeypatch.setattr(runner, "select_engine", lambda *a, **k: TorchEngine(CPU, threads=2))
    data = recipes.text_corpus(31, size) if size else np.empty(0, np.uint8)
    src, out = tmp_path / "in.txt", tmp_path / "out.bin"
    src.write_bytes(data.tobytes())
    ByteTokenizer(merges=learned_rules, content_type="Text", chunk_size="256KB",
                  threads=2).tokenize_file(str(src), str(out))
    chunks = _chunks(data, 256 << 10)
    oracle = b"".join(tokens_to_be_bytes(bpe_encode_oracle(c.tobytes(), learned_rules))
                      for c in chunks)
    assert out.read_bytes() == b"\xff\x01" + oracle == b"\xff\x01" + _reference(learned_rules, chunks)
