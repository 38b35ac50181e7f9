"""The torch port's CUDA kernels on the card (skipped without one).

Each kernel's wrapper is held against its plain PyTorch version on the same
CUDA tensors, exactly, and the engine and CLI against the host engine. This
file imports nothing of JAX or the JAX package, so it runs on a machine that
has only the port's dependencies; tests/conftest.py imports JAX, so skip it
there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import itertools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from blt_tpu_torch import cli
from blt_tpu_torch.io.sources import InputSource
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.ops import _cuda_build, bpe_cuda, bpe_torch, multipass_cuda, tools_cuda
from blt_tpu_torch.ops.bpe_numpy import bpe_encode_flat, bpe_encode_multipass
from blt_tpu_torch.ops.sharded_cuda import CudaShardedFlatEncoder, CudaShardedTokenEncoder
from blt_tpu_torch.ops.tables import cuckoo_planes, wire_table
from blt_tpu_torch.pipeline import feeder
from blt_tpu_torch.pipeline.engines import ShardedTorchEngine, TorchEngine
from blt_tpu_torch.tools import (
    _common,
    exp_16bit,
    exp_bf16scan,
    exp_chain,
    exp_chd,
    exp_compact,
    exp_dense,
    exp_e2e,
    exp_gap,
    exp_gapvar,
    exp_gather,
    exp_lookback,
    exp_mp,
    exp_mp_ablate,
    exp_multipass,
    exp_occ,
    exp_opt,
    exp_parts,
    exp_scan,
    exp_sweep,
)
from h100_bench.common import recipes
from h100_bench.tables import learned

pytestmark = pytest.mark.gpu

MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259, (255, 255): 0xFFFF}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _text(seed, n, alphabet=b"aabbcc \xffab"):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


def _join(results) -> bytes:
    return b"".join(bytes(memoryview(r).cast("B")) for r in results)


def test_kernels_equal_plain_versions(cuda):
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = torch.from_numpy(_text(10, (1 << 20) + 4096)).to(cuda)
    for n in (0, 1, 5000, 1 << 20, (1 << 20) + 4096):
        assert torch.equal(bpe_cuda.basic_encode(data[:n]), bpe_cuda.widen_plain(data[:n]))
        for carry, nb in ((0, -1), (1, 97), (1, 0), (0, 255)):
            c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
            s, co = bpe_cuda.flat_encode_slots(data, n, nb, table, c)
            sp, cp = bpe_cuda.flat_pass_plain(data, n, nb, table, c)
            assert torch.equal(s, sp) and torch.equal(co, cp), (n, carry, nb)
            prev = torch.tensor(0x6162, dtype=torch.int32, device=cuda)
            w, last = bpe_cuda.pack_slots(s, n, prev)
            wp, lp = bpe_cuda.pack_slots_plain(sp, n, prev)
            assert torch.equal(w, wp) and torch.equal(last, lp), (n, carry, nb)


def test_wrappers_count_launches_and_check_alignment(cuda):
    data = torch.zeros(4097, dtype=torch.uint8, device=cuda)
    bpe_cuda.reset_launches()
    bpe_cuda.basic_encode(data[:4096])
    assert bpe_cuda.launches["widen"] == 1
    with pytest.raises(ValueError, match="aligned"):
        bpe_cuda.basic_encode(data[1:])


def test_engine_streams_reuse_pinned_buffers(cuda):
    """One pinned staging buffer serves 65 batches: each upload must finish
    before the buffer is refilled, or batches would corrupt each other."""
    table = MergeTable.build(MERGES)
    hint = 4096
    data = _text(11, 64 * hint + 3)
    chunks = [data[i : i + hint] for i in range(0, data.shape[0], hint)]
    eng = TorchEngine(cuda, depth=4)
    bpe_cuda.reset_launches()
    got = _join(eng.bpe_stream(iter(chunks), table, hint))
    assert got == bpe_encode_flat(data, table).astype(">u2").tobytes()
    # one fused launch per batch: K2's three and the pack's no more
    assert bpe_cuda.launches["flat_bpe_packed"] == 65
    assert bpe_cuda.launches["flat_bpe"] == bpe_cuda.launches["pack_slots"] == 0
    got = _join(eng.basic_stream(iter(chunks), hint))
    assert got == data.astype(">u2").tobytes()
    assert bpe_cuda.launches["widen"] == 65


def test_cli_engine_torch_equals_engine_numpy(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("BLT_DEVICE_BATCH_BYTES", str(1 << 20))  # three batches
    src = tmp_path / "in.txt"
    src.write_bytes(_text(12, 3_000_000).tobytes())
    merges = tmp_path / "m.txt"
    merges.write_text("97 98\n98 99\n97 97\n255 255\n")
    for extra in ([], ["--merges", str(merges)]):
        outs = []
        for engine in ("torch", "numpy"):
            out = tmp_path / f"{engine}.bin"
            argv = ["-i", str(src), "-o", str(out), "--type", "text",
                    "--chunksize", "256KB", "--engine", engine]
            assert cli.main(argv + extra) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]


def test_mapped_input_uploads_from_its_mapping(cuda, tmp_path, monkeypatch):
    """A file's batches reach the card from its mapping, window by window
    (``feed.direct``): the basic, flat and multipass streams equal the
    staging copy of the same bytes and the host references. The file is a
    ``memfd``, whose pages CUDA pins; a file whose filesystem refuses
    (``feed.register_failed``) takes the staging copy, with the same bytes."""
    monkeypatch.setattr(feeder, "WINDOW_BYTES", 1 << 20)
    hint = 1 << 18
    data = _text(13, 3 * (1 << 20) + 12345)
    fd = os.memfd_create("blt-test-input")
    os.write(fd, data.tobytes())
    disk = tmp_path / "in.bin"
    disk.write_bytes(data.tobytes())
    flat, general = MergeTable.build(MERGES), MergeTable.build(GENERAL)
    runs = {
        "basic": (lambda e, c: e.basic_stream(c, hint), data.astype(">u2").tobytes()),
        "flat": (lambda e, c: e.bpe_stream(c, flat, hint),
                 bpe_encode_flat(data, flat).astype(">u2").tobytes()),
        "general": (lambda e, c: e.bpe_stream(c, general, hint), b"".join(
            bpe_encode_multipass(data[i : i + hint], general).astype(">u2").tobytes()
            for i in range(0, data.shape[0], hint))),
    }
    batches = -(-data.shape[0] // hint)

    def run(stream, chunks):
        feeder.stage_stats(reset=True)
        got = _join(stream(TorchEngine(cuda), chunks))
        return got, feeder.stage_stats(reset=True)

    try:
        for name, (stream, want) in runs.items():
            got, stats = run(stream, InputSource(Path(f"/proc/self/fd/{fd}")).chunks(hint))
            assert stats["feed.direct"]["items"] == batches, name
            assert stats["feed.direct"]["bytes"] == data.shape[0], name
            assert "feed.staged" not in stats and "feed.register_failed" not in stats, name
            staged, stats = run(stream, iter(
                data[i : i + hint].copy() for i in range(0, data.shape[0], hint)))
            assert stats["feed.staged"]["items"] == batches and "feed.direct" not in stats, name
            on_disk, stats = run(stream, InputSource(disk).chunks(hint))
            count = lambda k: stats.get(k, {}).get("items", 0)  # noqa: E731
            assert count("feed.direct") + count("feed.staged") == batches, name
            assert got == staged == on_disk == want, name
    finally:
        os.close(fd)


GENERAL = {(97, 98): 256, (256, 99): 257, (257, 257): 300, (97, 97): 301,
           (301, 301): 302, (0xFFFF, 97): 40000, (40000, 0xFFFF): 0xFFFF,
           (32768, 32768): 50000, (120, 121): 90, (90, 122): 0}


def _big_table(seed=3, n=7000):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(600 * 600)[:n]
    return MergeTable.build({(int(k) // 600, int(k) % 600): 600 + i for i, k in enumerate(keys)})


def test_token_passes_equal_plain_versions(cuda):
    """K3 and every round of ``TOKEN_PASSES`` (K4 in one launch and in
    three, T4's ablations) against their plain versions: empty, one and
    two tokens, tombstone runs of 1 to 5 across a tile edge, a hierarchical
    chain, tokens >= 32768 with 0xFFFF, and a table placed at 8192 slots."""
    rng = np.random.default_rng(20)
    tables = [MergeTable.build(GENERAL), _big_table()]
    assert cuckoo_planes(tables[1]).slots == 8192
    cap = 3 * 4096 + 256
    for table in tables:
        planes = cuckoo_planes(table, cuda)
        alphabet = np.array(sorted({x for p in table.merges for x in p})[:600]
                            + [97, 98, 99, 0xFFFF, 32768, 40000], np.int32)
        toks = rng.choice(alphabet, cap).astype(np.int32)
        toks[4000:4200] = 97  # a chain across the tile edge at 4096
        for n in (0, 1, 2, 4095, 4097, cap):
            t = torch.from_numpy(toks).to(cuda)
            for flags in multipass_cuda.TOKEN_PASSES.values():
                assert torch.equal(multipass_cuda.token_pass(t, n, planes, flags),
                                   multipass_cuda.token_pass_plain(t, n, planes, flags)), (n, flags)
            for run in range(1, 6):
                gap = toks.copy()
                gap[n:] = -1
                start = 4096 - (run + 1) // 2
                gap[start : start + run] = -1  # a run across the tile edge
                g = torch.from_numpy(gap).to(cuda)
                out, count = multipass_cuda.token_pass_gap(g, planes)
                ref, ref_count = multipass_cuda.token_pass_gap_plain(g, planes)
                assert torch.equal(out, ref) and int(count) == int(ref_count), (n, run)


@pytest.mark.parametrize("mode", ["gap", "sort", "twin"])
def test_multipass_engine_on_the_card(cuda, mode, monkeypatch):
    """Each route of a general table on the card: the K3 and K4 loops, one
    launch a round, and the plain twin (the route of a table cuckoo32
    cannot place), which launches no kernel; one loop a chunk, counted
    under its route."""
    if mode == "twin":
        monkeypatch.setenv("BLT_MULTIPASS", "xla")
    else:
        monkeypatch.setenv("BLT_MP_COMPACT", mode)
    table = MergeTable.build(GENERAL)
    hint = 64 * 1024
    data = _text(13, 5 * hint + 17, alphabet=b"aaaabbc xyz")
    chunks = [data[i : i + hint] for i in range(0, data.shape[0], hint)]
    multipass_cuda.reset_launches()
    feeder.stage_stats(reset=True)
    got = _join(TorchEngine(cuda).bpe_stream(iter(chunks), table, hint))
    expected = b"".join(bpe_encode_multipass(c, table).astype(">u2").tobytes() for c in chunks)
    assert got == expected
    rounds = sum(r for r, _ in multipass_cuda.loop_log)
    taken = "mp.twin" if mode == "twin" else "mp.loop"
    assert len(multipass_cuda.loop_log) == len(chunks) == feeder.stage_stats()[taken]["items"]
    if mode == "twin":
        assert sum(multipass_cuda.launches.values()) == 0 and rounds > 0
    else:
        kernel = "token_pass_lookback" if mode == "sort" else "token_pass_gap"
        assert multipass_cuda.launches[kernel] == rounds > 0


@pytest.fixture(scope="module")
def wide_table():
    """The benchmark's ``general50k`` table (``h100_bench/configs``): 50,000
    learned rules, placed by the wide cuckoo32 placement at 65,536 slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = {"rules": 50_000, "per_round": 500, "sample_bytes": 4 << 20}
    return MergeTable.build(learned.build(spec, 2**31 + 5, torch.device("cuda", 0)).rules)


def test_gap_round_on_the_wide_table_equals_plain_version(cuda, wide_table):
    """K3 over the 65,536-slot planes at 16 Mi positions of the benchmark's
    text, in three chained rounds (tombstones from the second on)."""
    planes = cuckoo_planes(wide_table, cuda)
    assert planes.slots == 65536
    toks = torch.from_numpy(recipes.text_corpus(41, 16 << 20).astype(np.int32)).to(cuda)
    for _ in range(3):
        out, count = multipass_cuda.token_pass_gap(toks, planes)
        ref, ref_count = multipass_cuda.token_pass_gap_plain(toks, planes)
        assert torch.equal(out, ref) and int(count) == int(ref_count)
        toks = out
    assert 0 < int(count) < 16 << 20


@pytest.mark.parametrize("mode", ["gap", "sort"])
def test_wide_table_engine_on_the_card(cuda, wide_table, mode, monkeypatch):
    """A ``TorchEngine`` on the card over 16 MiB chunks of the benchmark's
    text with the 50,000-rule table: the K3 loop (``BLT_MP_COMPACT=gap``)
    or the K4 loop (``sort``) on the wide planes, placed once, one launch
    of the loop's kernel a round, equal chunk by chunk to the plain twin
    (``bpe_torch.multipass_encode``)."""
    monkeypatch.setenv("BLT_MP_COMPACT", mode)
    hint = 16 << 20
    data = recipes.text_corpus(43, 2 * hint + 4097)
    chunks = [data[i : i + hint] for i in range(0, data.shape[0], hint)]
    multipass_cuda.reset_launches()
    feeder.stage_stats(reset=True)
    table = MergeTable.build(wide_table.merges)
    got = _join(TorchEngine(cuda).bpe_stream(iter(chunks), table, hint))
    stats = feeder.stage_stats(reset=True)
    assert stats["mp.loop"]["items"] == len(chunks) and "mp.twin" not in stats
    assert (stats["cuckoo.wide"]["items"], stats["cuckoo.wide"]["bytes"]) == (1, 1 << 20)
    kernel, other = "token_pass_gap", "token_pass_lookback"
    if mode == "sort":
        kernel, other = other, kernel
    rounds = sum(r for r, _ in multipass_cuda.loop_log)
    assert multipass_cuda.launches[kernel] == rounds > 0 and multipass_cuda.launches[other] == 0
    keys, vals = bpe_torch.sparse_table_device(table, cuda)
    expected = []
    for c in chunks:
        toks, m = bpe_torch.multipass_encode(torch.from_numpy(c).to(cuda), c.shape[0], keys, vals)
        expected.append(toks[: int(m)].cpu().numpy().astype(">u2").tobytes())
    assert got == b"".join(expected)


def test_chain_kernels_equal_plain_versions(cuda):
    """K5, T1 and T7 (chain.cu) against their plain versions."""
    data2 = torch.from_numpy(_text(14, 1024 * 128)).to(cuda).reshape(-1, 128)
    tok = torch.tensor([[5]], dtype=torch.int32, device=cuda)
    bpe_cuda.reset_launches()
    for k in (1, 2, 3):
        for rpb in (8, 512):
            got = bpe_cuda.basic_encode_chained(data2, tok, k, rpb)
            ref = bpe_cuda.basic_chained_plain(data2, tok, k, rpb)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (k, rpb)
            for fn, plain in ((exp_chain.copy_chain, exp_chain.copy_chain_plain),
                              (exp_chain.widen_chain, exp_chain.widen_chain_plain)):
                got, ref = fn(data2, tok, rpb, k), plain(data2, tok, rpb, k)
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (k, rpb)
    for rpb in (1, 8, 64, 1024):
        got, ref = exp_sweep.copy_pallas(data2, rpb), exp_sweep.copy_plain(data2, rpb)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), rpb
    # the copy ring's edges: one row; a span of one stage + 128 B (T7 over
    # three such steps, T1 over one), its last stage short; 64 MiB + 128 B
    # over T1's persistent grid; T1 chained 3 times from a nonzero token
    stage_rows = bpe_cuda.RING_STAGE_BYTES // 128 + 1
    big = torch.from_numpy(_text(16, (64 << 20) + 128)).to(cuda).reshape(-1, 128)
    for rows in (1, stage_rows, big.shape[0]):
        for k in (1, 3):
            got = exp_chain.copy_chain(big[:rows], tok, 1, k)
            ref = exp_chain.copy_chain_plain(big[:rows], tok, 1, k)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (rows, k)
    for rpb, rows in ((1, 1), (stage_rows, 3 * stage_rows)):
        got = exp_sweep.copy_pallas(big[:rows], rpb)
        ref = exp_sweep.copy_plain(big[:rows], rpb)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (rows, rpb)
    assert {k: bpe_cuda.launches[k] for k in bpe_cuda.CHAINS} == {
        "basic_chained": 12, "chain_copy": 24, "chain_widen": 12, "copy_sweep": 6}


def test_flat_parts_equal_plain_versions(cuda):
    """T8's four variants (flat_parts.cu) against their plain versions."""
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = torch.from_numpy(_text(15, (1 << 20) + 4096, b"aabbcc \xffab\x00hpx")).to(cuda)
    bpe_cuda.reset_launches()
    for variant in exp_parts.VARIANTS:
        for n in (0, 1, 4097, 1 << 20):
            for carry, nb in ((0, -1), (1, 97), (1, 0), (0, 255)):
                c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
                got = exp_parts.flat_parts(variant, data, n, nb, table, c)
                ref = exp_parts.flat_parts_plain(variant, data, n, nb, table, c)
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
                    variant, n, carry, nb)
    assert all(bpe_cuda.launches[f"parts_{v}"] == 16 for v in exp_parts.VARIANTS)
    assert bpe_cuda.launches["flat_bpe"] == 0


def test_chains_replay_from_a_cuda_graph(cuda):
    """A chain captured once replays with the same result; the wrappers
    count its launches once, at capture."""
    data2 = torch.from_numpy(_text(16, 256 * 128)).to(cuda).reshape(-1, 128)
    tok = torch.tensor([[3]], dtype=torch.int32, device=cuda)
    bpe_cuda.basic_encode_chained(data2, tok, 4, 8)  # loads the library
    bpe_cuda.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, last = bpe_cuda.basic_encode_chained(data2, tok, 4, 8)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    ref_out, ref_tok = bpe_cuda.basic_chained_plain(data2, tok, 4, 8)
    assert torch.equal(out, ref_out) and torch.equal(last, ref_tok)
    assert bpe_cuda.launches["basic_chained"] == 4
    timing = _common.time_chain(lambda: exp_chain.copy_chain(data2, tok, 8, 4), 4,
                                data2.numel(), cuda, exp_chain.copy_chain_plain(data2, tok, 8, 4))
    assert timing["graph"]["ms_per_launch"]["n"] == _common.REPS and timing["exact"]
    wrong = (ref_out, ref_tok + 1)
    assert not _common.time_chain(lambda: bpe_cuda.basic_encode_chained(data2, tok, 4, 8), 4,
                                  data2.numel(), cuda, wrong)["exact"]


def _equal(got, ref):
    if isinstance(got, torch.Tensor):
        return torch.equal(got, ref)
    return all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))


def test_probe_kernels_equal_plain_versions(cuda):
    """T9 (subgather.cu) on in-block and out-of-block indices, and T5
    (op_mix.cu) in each type over values that overflow it, chained 1 and 3
    times."""
    rng = np.random.default_rng(17)
    tools_cuda.reset_launches()
    rows = 4096
    tbl = torch.from_numpy(rng.integers(0, 1 << 30, (rows, 128), dtype=np.int32)).to(cuda)
    for rpb in (8, 1024):
        for lo, hi in ((0, rpb), (-2 * rpb, 2 * rpb), (-(2**31), 2**31 - 1)):
            idx = torch.from_numpy(
                rng.integers(lo, hi, (rows, 128), dtype=np.int64).astype(np.int32)).to(cuda)
            assert _equal(tools_cuda.subgather(tbl, idx, rpb),
                          tools_cuda.subgather_plain(tbl, idx, rpb)), (rpb, lo)
    tok = torch.tensor([[1000]], dtype=torch.int32, device=cuda)
    for name, dtype in tools_cuda.MIX_DTYPES.items():
        info = np.iinfo(name)
        x = torch.from_numpy(rng.integers(info.min, info.max + 1, (rows, 128), dtype=np.int64)
                             .astype(name)).to(cuda)
        for k in (1, 3):
            assert _equal(tools_cuda.op_mix(x, tok, k, 1024),
                          tools_cuda.op_mix_plain(x, tok, k, 1024)), (name, k)
    assert tools_cuda.launches["subgather"] == 6
    assert all(tools_cuda.launches[f"op_mix_{d}"] == 4 for d in tools_cuda.MIX_DTYPES)


# T9's slab path at rpb 8, 16, 1000 (not a multiple of a box's rows), 1024
# and 2048 (8 columns), 4096 (4 columns); 7240, 10000 and 16384 (no job
# fits: the direct path; at 7240 some CTAs' spans of 16 rows cross a
# block's end)
SUBGATHER_RPBS = (8, 16, 1000, 1024, 2048, 4096, 7240, 10000, 16384)


@pytest.mark.parametrize("rpb", SUBGATHER_RPBS)
def test_subgather_paths_equal_plain_version(cuda, rpb):
    """T9 on indices in [0, 8), in the block, in [-rpb, 0) (the wrap from the
    end), far outside it (every element filled) and mixed, on two blocks;
    each launch counts under its path."""
    rng = np.random.default_rng(rpb)
    rows = 2 * rpb
    tbl = torch.from_numpy(rng.integers(0, 1 << 30, (rows, 128), dtype=np.int32)).to(cuda)
    ranges = ((0, 8), (0, rpb), (-rpb, 0), (rpb, 2**31 - 1), (-(2**31), 2**31 - 1),
              (-2 * rpb, 2 * rpb))
    kernel = tools_cuda.subgather_plan(rows, rpb)["kernel"]
    assert (kernel == "subgather_direct") == (rpb > 7232)
    tools_cuda.reset_launches()
    for lo, hi in ranges:
        idx = torch.from_numpy(
            rng.integers(lo, hi, (rows, 128), dtype=np.int64).astype(np.int32)).to(cuda)
        assert _equal(tools_cuda.subgather(tbl, idx, rpb),
                      tools_cuda.subgather_plain(tbl, idx, rpb)), (lo, hi)
    assert tools_cuda.launches[kernel] == len(ranges)


def _gap_cases(rng, planes_chain, planes_big, alphabet):
    """K3 inputs whose tiles are all identity (dead), all flips (one long
    match run), reset-bearing, and tombstone runs across tile edges."""
    cap = 64 * 4096
    dead = np.full(cap, -1, np.int32)
    dead[:100] = 97
    dead[-4096 - 50 :] = 97  # live tokens, 60 dead tiles between
    flips = np.full(cap, 97, np.int32)  # every pair of CHAIN matches
    flips[5 * 4096 + 7] = 98  # one reset in tile 5
    mixed = rng.choice(alphabet, cap).astype(np.int32)
    runs = mixed.copy()
    for edge in range(4096, cap, 4096):
        run = int(rng.integers(1, 6))
        runs[edge - run // 2 : edge - run // 2 + run] = -1
    return [(dead, planes_chain), (flips, planes_chain), (mixed, planes_big),
            (runs, planes_big)]


def test_gap_round_equals_plain_version_on_look_back_cases(cuda):
    """K3's look-back over dead tiles, all-flip tiles, reset-bearing and
    tombstone-run tiles, and over its own output for three more rounds."""
    rng = np.random.default_rng(23)
    chain = cuckoo_planes(MergeTable.build({(97, 97): 256, (256, 256): 257, (257, 257): 258}),
                          cuda)
    table = _big_table()
    big = cuckoo_planes(table, cuda)
    alphabet = np.array(sorted({x for p in table.merges for x in p})[:600], np.int32)
    for toks, planes in _gap_cases(rng, chain, big, alphabet):
        g = torch.from_numpy(toks).to(cuda)
        for r in range(4):
            out, count = multipass_cuda.token_pass_gap(g, planes)
            ref, ref_count = multipass_cuda.token_pass_gap_plain(g, planes)
            assert torch.equal(out, ref) and int(count) == int(ref_count), r
            g = out


def test_gap_round_replays_from_a_cuda_graph(cuda):
    """A chain of K3 rounds captured once replays with the same result: the
    status words, ticket and count are zeroed on the stream each round."""
    rng = np.random.default_rng(24)
    table = _big_table()
    planes = cuckoo_planes(table, cuda)
    alphabet = np.array(sorted({x for p in table.merges for x in p})[:600], np.int32)
    t = torch.from_numpy(rng.choice(alphabet, 1 << 20).astype(np.int32)).to(cuda)
    expect = exp_mp_ablate.feed_back(
        lambda x: multipass_cuda.token_pass_gap_plain(x, planes), t, 4)
    multipass_cuda.reset_launches()
    timing = _common.time_chain(
        lambda: exp_mp_ablate.feed_back(lambda x: multipass_cuda.token_pass_gap(x, planes), t, 4),
        4, t.numel() * 4, cuda, expect)
    assert timing["exact"] and timing["graph"] is not None
    # the warm-up, the timed runs and the capture; replays launch nothing new
    assert multipass_cuda.launches["token_pass_gap"] == 4 * (2 + _common.REPS)


def test_ablation_kernels_equal_plain_versions(cuda):
    """T4 (K4's round under other flags, and token_parts.cu) chained three
    times through its tombstones, full against K4; T6 (K2's pass under
    other flags, and scan_parts.cu) at rows_per_block 8 and 1024, full
    against K2."""
    rng = np.random.default_rng(18)
    for m in (bpe_cuda, multipass_cuda, tools_cuda):
        m.reset_launches()
    planes = cuckoo_planes(MergeTable.build(exp_mp_ablate.HIER), cuda)
    cap = 4 * 4096 + 256
    toks = torch.from_numpy(rng.choice(np.array([97, 98, 99, 32, 256, 257, -1, 0xFFFF], np.int32),
                                       cap)).to(cuda)
    for variant in exp_mp_ablate.VARIANTS:
        for n in (0, 1, 4097, cap):
            got = exp_mp_ablate.chain(variant, toks, n, planes, 3)
            assert torch.equal(got, exp_mp_ablate.chain_plain(variant, toks, n, planes, 3)), (
                variant, n)
            if variant == "full":
                assert torch.equal(exp_mp_ablate.token_parts("full", toks, n, planes),
                                   multipass_cuda.token_pass_plain(toks, n, planes))
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = torch.from_numpy(_text(19, 1 << 20, b"aabbcc \xffab\x00hpx")).to(cuda)
    for variant in exp_scan.VARIANTS:
        for rpb in (8, 1024):
            for n, carry, nb in ((0, 1, -1), (1, 0, 97), (4097, 1, 0), (1 << 20, 1, -1)):
                c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
                got = exp_scan.chain(variant, data, n, nb, table, c, 2, rpb)
                assert _equal(got, exp_scan.chain_plain(variant, data, n, nb, table, c, 2, rpb)), (
                    variant, rpb, n, carry, nb)
                if variant == "full":
                    assert _equal(exp_scan.scan_parts("full", data, n, nb, table, c, rpb),
                                  bpe_cuda.flat_pass_plain(data, n, nb, table, c))
    # T4's full is K4 and T6's full is K2: they count under K4's and K2's names
    assert multipass_cuda.launches["token_pass"] == 16
    assert all(multipass_cuda.launches[f"token_parts_{v}"] == 12
               for v in ("noscan", "nolookup", "noshift"))
    assert tools_cuda.launches["token_parts_copy"] == 12
    assert bpe_cuda.launches["flat_bpe"] == 24
    assert all(bpe_cuda.launches[f"scan_parts_{v}"] == 16
               for v in ("noscan", "nolookup", "noshifts"))
    assert all(tools_cuda.launches[f"scan_parts_{v}"] == 16 for v in tools_cuda.BLOCK_SCANS)


def _swapped_starts(slots):
    s = slots.to(torch.int32)
    return torch.where((s & 0xFF) != 0, ((s & 0xFF) << 8) | (s >> 8), s)


def test_design_probe_passes_equal_plain_versions(cuda):
    """T2's four variants (look-back, staged table) against their plain
    versions and against K2 with its starts byteswapped, over an all-match
    run of 1000 tiles too; T10's prod against K2, novalid and noscan2 (rows
    per block 8 and 1024) against their plain versions."""
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = torch.from_numpy(_text(21, 1 << 20, b"aabbcc \xffab\x00hpx")).to(cuda)
    run = torch.full((4 << 20,), 97, dtype=torch.uint8, device=cuda)
    bpe_cuda.reset_launches()
    tools_cuda.reset_launches()
    cases = [(data, n, carry, nb) for n in (0, 1, 4097, 1 << 20)
             for carry, nb in ((0, -1), (1, 97), (1, 0), (0, 255))]
    cases += [(run, (4 << 20) - 3, carry, 97) for carry in (0, 1)]
    for d, n, carry, nb in cases:
        c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
        k2, k2_c = bpe_cuda.flat_pass_plain(d, n, nb, table, c)
        for variant in exp_opt.VARIANTS:
            vt = exp_opt.variant_table(variant, table)
            got = exp_opt.opt_pass(variant, d, n, nb, vt, c)
            assert _equal(got, exp_opt.opt_pass_plain(variant, d, n, nb, vt, c)), (variant, n, nb)
            assert torch.equal(got[0].to(torch.int32), _swapped_starts(k2))
            assert torch.equal(got[1], k2_c)
        assert _equal(exp_chd.chd_pass("prod", d, n, nb, table, c), (k2, k2_c))
        for variant, rpb in (("novalid", 1024), ("noscan2", 8), ("noscan2", 1024)):
            got = exp_chd.chd_pass(variant, d, n, nb, table, c, rpb)
            assert _equal(got, exp_chd.chd_pass_plain(variant, d, n, nb, table, c, rpb)), (
                variant, rpb, n, nb)
    assert {k: bpe_cuda.launches[k] for k in ("parts_full", "opt_p2", "opt_hoist", "opt_swap",
                                               "flat_bpe", "chd_novalid")} == dict.fromkeys(
        ("parts_full", "opt_p2", "opt_hoist", "opt_swap", "flat_bpe", "chd_novalid"), 18)
    assert tools_cuda.launches["chd_noscan2"] == 36


def test_look_back_replays_from_a_cuda_graph(cuda):
    """The look-back zeroes its status words on the stream, so a captured
    chain of it replays with the same result."""
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = torch.from_numpy(_text(22, 1 << 20)).to(cuda)
    c = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    for variant in ("p2", "p2+hoist"):
        expect = bpe_cuda.chain_passes(
            lambda x, variant=variant: exp_opt.opt_pass_plain(variant, data, 1 << 20, 97, table, x),
            c, 4)
        timing = _common.time_chain(
            lambda variant=variant: exp_opt.chain(variant, data, 1 << 20, 97, table, c, 4), 4,
            data.numel(), cuda, expect)
        assert timing["exact"] and timing["graph"] is not None, variant


def test_look_back_k4_equals_plain_version(cuda):
    """K4 as the main path runs it (one look-back launch) against its plain
    version: short buffers, a match run over a whole tile, a merge starting
    on a tile's last position, over its own output for two more rounds,
    and the 8192-slot table."""
    rng = np.random.default_rng(25)
    cap = 3 * 4096 + 256
    for table in (MergeTable.build(GENERAL), _big_table()):
        planes = cuckoo_planes(table, cuda)
        alphabet = np.array(sorted({x for p in table.merges for x in p})[:600]
                            + [97, 98, 99, 0xFFFF, 32768, 40000], np.int32)
        toks = rng.choice(alphabet, cap).astype(np.int32)
        toks[4090:8300] = 97  # (97, 97) matches in GENERAL: tile 1 holds no non-match
        toks[12285:12288] = [120, 97, 98]  # (97, 98) starts on tile 2's last position
        for n in (0, 1, 7, 8, 4095, 4096, 4097, 12289, cap):
            t = torch.from_numpy(toks).to(cuda)
            for r in range(3):
                got = multipass_cuda.token_pass(t, n, planes, multipass_cuda.K4_FLAGS)
                ref = multipass_cuda.token_pass_plain(t, n, planes)
                assert torch.equal(got, ref), (n, r)
                t = got


def test_look_back_k4_replays_from_a_cuda_graph(cuda):
    """A chain of look-back K4 rounds captured once replays with the same
    result (the status words and ticket are zeroed on the stream), beside
    the three-launch rounds."""
    planes = cuckoo_planes(_big_table(), cuda)
    rng = np.random.default_rng(26)
    toks = torch.from_numpy(rng.integers(0, 600, 1 << 20).astype(np.int32)).to(cuda)
    multipass_cuda.reset_launches()
    rows = exp_lookback.k4_rows(toks, toks.numel() - 5, planes, k=4)
    assert [r["name"] for r in rows] == ["lookback", "three_launch"]
    assert all(r["exact"] and r["graph"] is not None for r in rows)
    # the warm-up, the timed runs and the capture; replays launch nothing new
    assert multipass_cuda.launches["token_pass_lookback"] == 4 * (2 + _common.REPS)
    assert multipass_cuda.launches["token_pass"] == 4 * (2 + _common.REPS)


def test_packed_pass_equals_plain_version(cuda):
    """K2 and its pack as one launch against K2's plain pass packed by the
    plain pack: short and tile-edge lengths, both carries, a prev_slot that
    is a merge start, next_byte -1, 0 and 97, an all-match run over many
    tiles, and a merge starting on a tile's last position."""
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = _text(27, (1 << 20) + 4096)
    data[4093:4096] = [32, 97, 98]  # (32, 97) no rule, (97, 98) starts at 4095
    d = torch.from_numpy(data).to(cuda)
    run = torch.full((4 << 20,), 97, dtype=torch.uint8, device=cuda)
    bpe_cuda.reset_launches()
    cases = [(d, n, carry, nb, prev) for n in (0, 1, 7, 8, 4095, 4096, 4097, 5000, 1 << 20)
             for carry, nb, prev in ((0, -1, 0), (1, 97, 0x0161), (1, 0, 0x6100), (0, 97, 0x0262))]
    cases += [(run, (4 << 20) - 3, carry, 97, 0x0161) for carry in (0, 1)]
    for x, n, carry, nb, prev in cases:
        c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
        p = torch.tensor(prev, dtype=torch.int32, device=cuda)
        got = bpe_cuda.flat_encode_packed(x, n, nb, table, c, p)
        want = bpe_cuda.flat_packed_plain(x, n, nb, table, c, p)
        assert _equal(got, want), (x.numel(), n, carry, nb, prev)
    assert bpe_cuda.launches["flat_bpe_packed"] == len(cases)
    assert bpe_cuda.launches["flat_bpe"] == bpe_cuda.launches["pack_slots"] == 0


def test_packed_pass_replays_from_a_cuda_graph(cuda):
    """Fused passes chained through carry and last_slot, captured once,
    replay with the same wire, beside K2 + pack chained the same way."""
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    data = torch.from_numpy(_text(28, 1 << 20)).to(cuda)
    bpe_cuda.reset_launches()
    rows = exp_lookback.k2_rows(data, (1 << 20) - 3, table, k=4)
    assert [r["name"] for r in rows] == ["packed", "k2_pack"]
    assert all(r["exact"] and r["graph"] is not None for r in rows)
    assert bpe_cuda.launches["flat_bpe_packed"] == 4 * (2 + _common.REPS)
    assert bpe_cuda.launches["flat_bpe"] == bpe_cuda.launches["pack_slots"] == 4 * (
        2 + _common.REPS)


def test_mask_scans_and_lookups_equal_plain_versions(cuda):
    """T12's two scans on random masks, single and chained; T13's five
    lookups on p inside and outside [0, 65536) at 1000 and 4096 rows (32
    and 128 CTAs of 4 Ki elements, 16 and 64 of g2d_flat's 8 Ki), once and
    chained."""
    rng = np.random.default_rng(23)
    tools_cuda.reset_launches()
    for density in (0.3, 0.7):
        mask = torch.from_numpy(exp_bf16scan.random_mask(rng, 2048, density)).to(cuda)
        for rpb in (8, 1024):
            for variant in tools_cuda.MASK_SCANS:
                assert torch.equal(tools_cuda.mask_scan(variant, mask, rpb),
                                   tools_cuda.mask_scan_plain(mask, rpb)), (density, rpb)
                assert torch.equal(exp_bf16scan.chain(variant, mask, 3, rpb),
                                   exp_bf16scan.chain_plain(mask, 3, rpb))
    assert all(tools_cuda.launches[f"bf16scan_{v}"] == 16 for v in tools_cuda.MASK_SCANS)
    _, packed = exp_gather.build_table()
    tables = {"packed": torch.from_numpy(packed).to(cuda),
              "tbl8": torch.from_numpy(exp_gather.build_tbl8()).to(cuda)}
    for rows, (lo, hi) in itertools.product((1000, 4096), ((0, 65536), (-(2**31), 2**31 - 1))):
        p = torch.from_numpy(rng.integers(lo, hi, (rows, 128), dtype=np.int64)
                             .astype(np.int32)).to(cuda)
        for variant in tools_cuda.LOOKUPS:
            tbl = tables["tbl8" if variant == "g8bit" else "packed"]
            assert torch.equal(tools_cuda.lookup(variant, tbl, p),
                               tools_cuda.lookup_plain(variant, tbl, p)), (variant, rows, lo)
            assert torch.equal(exp_gather.chained(variant, tbl, p, 3),
                               exp_gather.chained_plain(variant, tbl, p, 3)), (variant, rows, lo)
    assert all(tools_cuda.launches[f"gather_{v}"] == 16 for v in tools_cuda.LOOKUPS)


def test_lookup_chains_replay_from_a_cuda_graph(cuda):
    """A captured chain of 4 of each T13 lookup at 4096 rows replays with the
    plain chain's result; the SMs hold one CTA each of the variants staging
    the 128 KiB table, and at least one of g2d_flat's and g8bit's."""
    _, packed = exp_gather.build_table()
    tables = {"packed": torch.from_numpy(packed).to(cuda),
              "tbl8": torch.from_numpy(exp_gather.build_tbl8()).to(cuda)}
    p = torch.from_numpy(np.random.default_rng(29).integers(0, 65536, (4096, 128))
                         .astype(np.int32)).to(cuda)
    for variant in tools_cuda.LOOKUPS:
        tbl = tables["tbl8" if variant == "g8bit" else "packed"]
        expect = exp_gather.chained_plain(variant, tbl, p, 4)
        timing = _common.time_chain(lambda: (exp_gather.chained(variant, tbl, p, 4),), 4,
                                    4 * p.numel(), cuda, (expect,))
        assert timing["exact"] and timing["graph"] is not None, variant
        per_sm = _cuda_build.ctas_per_sm(f"lookup_{variant}")
        big = tools_cuda.LOOKUP_STAGED[variant] == 4 * 256 * 128
        assert (per_sm == 1) if big else (per_sm >= 1), (variant, per_sm)


def test_mask_scan_tiles_equal_plain_version(cuda):
    """T12's two scans at rows per segment 8, 24, 1016 and 1024 on masks of
    density 0, 0.3, 0.7 and 1 (whole segments; 24's and 1016's leave the
    last tile partial), once and chained 3 times: one launch each."""
    rng = np.random.default_rng(26)
    tools_cuda.reset_launches()
    cases = 0
    for density in (0.0, 0.3, 0.7, 1.0):
        full = exp_bf16scan.random_mask(rng, 4096, density)
        for rpb in (8, 24, 1016, 1024):
            mask = torch.from_numpy(full[: full.shape[0] // rpb * rpb]).to(cuda)
            for variant in tools_cuda.MASK_SCANS:
                assert torch.equal(tools_cuda.mask_scan(variant, mask, rpb),
                                   tools_cuda.mask_scan_plain(mask, rpb)), (variant, density, rpb)
                assert torch.equal(exp_bf16scan.chain(variant, mask, 3, rpb),
                                   exp_bf16scan.chain_plain(mask, 3, rpb)), (variant, density, rpb)
            cases += 1
    assert all(tools_cuda.launches[f"bf16scan_{v}"] == 4 * cases for v in tools_cuda.MASK_SCANS)
    # rows are read as 16-byte vectors: a mask 4 bytes off is refused
    off = torch.zeros(8 * 128 + 4, dtype=torch.uint8, device=cuda)[4:].reshape(8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tools_cuda.mask_scan("i32", off, 8)


def test_mask_scan_chain_replays_from_a_cuda_graph(cuda):
    """A captured T12 chain of 4 (four memsets and four launches) replays
    with the plain chain's result, in both variants."""
    mask = torch.from_numpy(exp_bf16scan.random_mask(np.random.default_rng(27), 24 * 300,
                                                     0.3)).to(cuda)
    for variant in tools_cuda.MASK_SCANS:
        expect = exp_bf16scan.chain_plain(mask, 4, 24)
        timing = _common.time_chain(lambda: (exp_bf16scan.chain(variant, mask, 4, 24),), 4,
                                    mask.numel(), cuda, (expect,))
        assert timing["exact"] and timing["graph"] is not None, variant


def test_probes_take_every_row_count(cuda):
    """T3's six probes and T11's two at 1, 8, 13, 512, 513 and 131072 rows
    (partial warps and CTAs of rows), on the originals' x and on random
    |x| < 2**30."""
    rng = np.random.default_rng(28)
    for rows in (1, 8, 13, 512, 513, 131072):
        rand = torch.from_numpy(rng.integers(-(2**30) + 1, 2**30, (rows, 128), dtype=np.int64)
                                .astype(np.int32))
        for x in (exp_16bit.original_x(rows), rand):
            x = x.to(cuda)
            for probe in tools_cuda.PROBES16:
                assert torch.equal(tools_cuda.probe16(probe, x),
                                   tools_cuda.probe16_plain(probe, x)), (probe, rows)
    off = torch.zeros(8 * 128 + 1, dtype=torch.int32, device=cuda)[1:].reshape(8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tools_cuda.probe16("probe16_bf16_max", off)


def test_one_hot_lookups_and_probes_equal_plain_versions(cuda):
    """T14 in int8 and bf16 on p inside and outside [0, 65536), once and
    chained, at tiles 512, 48, 16 and 80 (all but 512 end inside a 64-row
    warpgroup tile) and at 133 tiles of 512, one more than the SMs; the
    eight 16-bit probes of T3 and T11 on the originals' x and on random
    |x| < 2**30 at 512, 8 and 13 rows."""
    rng = np.random.default_rng(24)
    tools_cuda.reset_launches()
    val16, _ = exp_gather.build_table()
    for lo, hi in ((0, 65536), (-(2**31), 2**31 - 1)):
        for rows, tiles in ((120, (512, 48, 16, 80)), (532, (512,))):
            p = torch.from_numpy(rng.integers(lo, hi, (rows, 128), dtype=np.int64)
                                 .astype(np.int32)).to(cuda)
            for dtype in tools_cuda.MXU_DTYPES:
                planes = tools_cuda.mxu_planes(val16, dtype).to(cuda)
                for tile in tiles:
                    assert torch.equal(tools_cuda.pmxu(dtype, planes, p, tile=tile),
                                       tools_cuda.pmxu_plain(dtype, planes, p, tile=tile)), (
                        dtype, lo, rows, tile)
                    assert torch.equal(
                        exp_gather.chained_mxu(dtype, planes, p, 3, tile),
                        exp_gather.chained_mxu(dtype, planes, p, 3, tile, plain=True)), (
                        dtype, lo, rows, tile)
    assert all(tools_cuda.launches[f"gather_{v}"] == 40 for v in tools_cuda.MXU_LOOKUPS)
    for rows in (512, 8, 13):
        rand = torch.from_numpy(rng.integers(-(2**30) + 1, 2**30, (rows, 128), dtype=np.int64)
                                .astype(np.int32))
        for x in (exp_16bit.original_x(rows), rand):
            x = x.to(cuda)
            for probe in tools_cuda.PROBES16:
                assert torch.equal(tools_cuda.probe16(probe, x),
                                   tools_cuda.probe16_plain(probe, x)), (probe, rows)
    assert all(tools_cuda.launches[p] == 6 for p in tools_cuda.PROBES16)


def test_one_hot_chain_replays_from_a_cuda_graph(cuda):
    """A captured T14 chain replays with the plain chain's result."""
    val16, _ = exp_gather.build_table()
    p = torch.from_numpy(np.random.default_rng(25).integers(0, 65536, (64, 128))
                         .astype(np.int32)).to(cuda)
    for dtype in tools_cuda.MXU_DTYPES:
        planes = tools_cuda.mxu_planes(val16, dtype).to(cuda)
        expect = exp_gather.chained_mxu(dtype, planes, p, 4, plain=True)
        timing = _common.time_chain(lambda: (exp_gather.chained_mxu(dtype, planes, p, 4),), 4,
                                    4 * p.numel(), cuda, (expect,))
        assert timing["exact"] and timing["graph"] is not None, dtype


def test_chain_lookup_equals_plain_version(cuda):
    """T13's chain (one read of a table staged by bulk copies an element,
    the grid sized to the work) on p inside and outside [0, 65536) at 1000
    and 4096 rows, once and chained, and a captured chain replayed."""
    rng = np.random.default_rng(26)
    _, packed = exp_gather.build_table()
    tbl = torch.from_numpy(packed).to(cuda)
    tools_cuda.reset_launches()
    for rows in (1000, 4096):
        for lo, hi in ((0, 65536), (-(2**31), 2**31 - 1)):
            p = torch.from_numpy(rng.integers(lo, hi, (rows, 128), dtype=np.int64)
                                 .astype(np.int32)).to(cuda)
            assert torch.equal(tools_cuda.lookup("chain", tbl, p),
                               tools_cuda.lookup_plain("chain", tbl, p)), (rows, lo)
            assert torch.equal(exp_gather.chained("chain", tbl, p, 3),
                               exp_gather.chained_plain("chain", tbl, p, 3)), (rows, lo)
    assert tools_cuda.launches["gather_chain"] == 16
    p = torch.from_numpy(rng.integers(0, 65536, (4096, 128)).astype(np.int32)).to(cuda)
    expect = exp_gather.chained_plain("chain", tbl, p, 4)
    timing = _common.time_chain(lambda: (exp_gather.chained("chain", tbl, p, 4),), 4,
                                4 * p.numel(), cuda, (expect,))
    assert timing["exact"] and timing["graph"] is not None


def _segment_buffer(rpb, segments, seed):
    """Random text in which every segment of rpb rows ends in a start (for
    scan16 and swarpack alike): its last row all (a, a) matches after (x, a)
    at an even position, and its last pair (a, b) a rule."""
    seg = rpb * 128
    data = _text(seed, segments * seg, b"aabbcc \xffab\x00hpx")
    for s in range(seg, segments * seg, seg):
        data[s - 130] = ord("x")
        data[s - 129 : s] = ord("a")
        data[s] = ord("b")
    return data


def test_row_scan_equals_plain_version_on_segment_cases(cuda):
    """T10's noscan2 (one launch, a look-back over the blocks' carry maps)
    at rows_per_block 8, 16, 24 and 1024 on T6's segment cases, an
    all-match buffer and one whose every fifth block has a space in its
    last row (constant maps among identities): n at the capacity, 3001 and
    1, carry 0 and 1, next_byte -1 and 98; then chains of 4 replayed from a
    CUDA graph."""
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    tools_cuda.reset_launches()
    for rpb in (8, 16, 24, 1024):
        seg = rpb * 128
        mixed = np.full(64 * seg, 97, np.uint8)
        mixed[np.arange(2, 64, 5) * seg + seg - 88] = 32
        for data in (_segment_buffer(rpb, 64 if rpb < 1024 else 3, rpb),
                     np.full(3 * seg, 97, np.uint8), mixed):
            d = torch.from_numpy(data).to(cuda)
            for n, carry, nb in itertools.product((d.numel(), 3001, 1), (0, 1), (-1, 98)):
                c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
                assert _equal(tools_cuda.row_scan(d, n, nb, table, c, rpb),
                              tools_cuda.row_scan_plain(d, n, nb, table, c, rpb)), (rpb, n, carry,
                                                                                    nb)
    assert tools_cuda.launches["chd_noscan2"] == 144
    for rpb in (8, 16, 1024):
        d = torch.from_numpy(_segment_buffer(rpb, 16, 30 + rpb)).to(cuda)
        c = torch.ones((1, 1), dtype=torch.int32, device=cuda)
        expect = bpe_cuda.chain_passes(lambda c, d=d, rpb=rpb: tools_cuda.row_scan_plain(
            d, d.numel() - 3, 98, table, c, rpb), c, 4)
        timing = _common.time_chain(
            lambda d=d, rpb=rpb: exp_chd.chain("noscan2", d, d.numel() - 3, 98, table, c, 4, rpb),
            4, d.numel(), cuda, expect)
        assert timing["exact"] and timing["graph"] is not None, rpb


def test_block_scans_equal_plain_version_on_segment_cases(cuda):
    """T6's scan16 and swarpack (one launch, a CTA per job of whole
    segments) at rows_per_block 8, 16 and 1024: n at the capacity, 3001
    and 1, carry 0 and 1, next_byte -1 and 98, segments that end in a
    start, and an all-match run; then chains replayed from a CUDA graph."""
    table = wire_table(MergeTable.build(MERGES).dense, cuda)
    tools_cuda.reset_launches()
    for rpb in (8, 16, 1024):
        for data in (_segment_buffer(rpb, 64 if rpb < 1024 else 3, rpb),
                     np.full(3 * rpb * 128, 97, np.uint8)):
            d = torch.from_numpy(data).to(cuda)
            cap = d.numel()
            for n, carry, nb in itertools.product((cap, 3001, 1), (0, 1), (-1, 98)):
                c = torch.tensor([[carry]], dtype=torch.int32, device=cuda)
                for variant in tools_cuda.BLOCK_SCANS:
                    got = tools_cuda.block_scan(variant, d, n, nb, table, c, rpb)
                    assert _equal(got, tools_cuda.block_scan_plain(variant, d, n, nb, table, c,
                                                                   rpb)), (variant, rpb, n, carry, nb)
    assert all(tools_cuda.launches[f"scan_parts_{v}"] == 72 for v in tools_cuda.BLOCK_SCANS)
    for rpb in (8, 16, 1024):
        d = torch.from_numpy(_segment_buffer(rpb, 16, 30 + rpb)).to(cuda)
        c = torch.ones((1, 1), dtype=torch.int32, device=cuda)
        for variant in tools_cuda.BLOCK_SCANS:
            expect = exp_scan.chain_plain(variant, d, d.numel() - 3, 98, table, c, 4, rpb)
            timing = _common.time_chain(
                lambda variant=variant: exp_scan.chain(variant, d, d.numel() - 3, 98, table, c, 4,
                                                       rpb), 4, d.numel(), cuda, expect)
            assert timing["exact"] and timing["graph"] is not None, (variant, rpb)


@pytest.mark.parametrize("mode", ["gap", "sort"])
def test_sharded_encoders_on_four_rows_of_the_card(cuda, mode, monkeypatch):
    """Both sharded encoders on [cuda:0] * 4 against the same encoders on
    four CPU rows (their plain versions), with K2, K3 or K4 launched a row."""
    monkeypatch.setenv("BLT_MP_COMPACT", mode)
    cpu = torch.device("cpu")
    table = MergeTable.build(MERGES)
    slabs = {d: CudaShardedFlatEncoder(table, [d] * 4, capacity_bytes=64 * 1024)
             for d in (cuda, cpu)}
    enc = slabs[cuda]
    batch = _text(31, 4 * enc.padded_bytes).reshape(4, -1)
    lengths = np.array([enc.padded_bytes, enc.padded_bytes, 5000, 0], np.int32)
    next_bytes = np.array([97, 98, -1, -1], np.int32)
    bpe_cuda.reset_launches()
    got = enc.encode_batch(batch, lengths, next_bytes)
    assert bpe_cuda.launches["flat_bpe_packed"] == 3  # the non-empty slabs
    want = slabs[cpu].encode_batch(batch, lengths, next_bytes)
    for r, n in enumerate(lengths):
        if n:
            cap = enc.capacity
            w, wp = got[0][r].cpu(), want[0][r]
            assert torch.equal(w[:n], wp[:n]) and torch.equal(got[1][r].cpu(), want[1][r])
            bits = np.unpackbits(w[cap:].numpy(), bitorder="little")[:n]
            assert (bits == np.unpackbits(wp[cap:].numpy(), bitorder="little")[:n]).all()

    general = MergeTable.build(GENERAL)
    chunks = [_text(40 + i, s, alphabet=b"aaaabbc xyz") for i, s in
              enumerate((64 * 1024, 1, 0, 40_000))]
    multipass_cuda.reset_launches()
    rows = CudaShardedTokenEncoder(general, [cuda] * 4, 64 * 1024).encode_batch_resident(chunks)
    rounds = sum(r for r, _ in multipass_cuda.loop_log)
    kernel = "token_pass_lookback" if mode == "sort" else "token_pass_gap"
    assert multipass_cuda.launches[kernel] == rounds > 0
    plain = CudaShardedTokenEncoder(general, [cpu] * 4, 64 * 1024).encode_batch_resident(chunks)
    assert [r.tolist() for r in rows] == [p.tolist() for p in plain]
    assert [r.tolist() for r in rows] == [bpe_encode_multipass(c, general).tolist()
                                          for c in chunks]


def test_shard_engine_degenerate_batch_on_the_card(cuda):
    """A run of one byte across a slab boundary sends its batch through the
    carry composition on the card; the stream stays exact."""
    table = MergeTable.build({**MERGES, (120, 120): 300})
    engine = ShardedTorchEngine([cuda] * 4)
    hint = 4 * 64 * 1024
    data = _text(50, 3 * hint + 123)
    for center in (hint + 64 * 1024, 2 * hint + 128 * 1024):
        data[center - 1501 : center + 700] = 120  # odd runs over slab boundaries
    chunks = [data[i : i + hint] for i in range(0, data.shape[0], hint)]
    bpe_cuda.reset_launches()
    got = _join(engine.bpe_stream(iter(chunks), table, hint))
    assert got == bpe_encode_flat(data, table).astype(">u2").tobytes()
    assert engine.counts["carry_batches"] == 2
    # fused K2 runs every slab of the two packed batches (0 and 3), a slab
    # a quarter of the hint
    packed = (chunks[0], chunks[3])
    assert bpe_cuda.launches["flat_bpe_packed"] == sum(-(-c.size // (hint // 4)) for c in packed)


def test_shard_engine_mixed_mesh_routes_each_row_by_its_device(cuda, monkeypatch):
    """A mesh of a card row and a CPU row: general-table chunks on the card
    row launch K3 (K4 under sort), those on the CPU row run the plain loop;
    the stream is exact."""
    general = MergeTable.build(GENERAL)
    engine = ShardedTorchEngine([cuda, torch.device("cpu")])
    chunks = [_text(60 + i, 40_000, alphabet=b"aaaabbc xyz") for i in range(4)]
    want = b"".join(bpe_encode_multipass(c, general).astype(">u2").tobytes() for c in chunks)
    for mode, kernel in (("gap", "token_pass_gap"), ("sort", "token_pass_lookback")):
        monkeypatch.setenv("BLT_MP_COMPACT", mode)
        multipass_cuda.reset_launches()
        assert _join(engine.bpe_stream(iter(chunks), general, 40_000)) == want, mode
        # chunks 0 and 2 on the card: their rounds are the launches
        rounds = [r for r, _ in multipass_cuda.loop_log]
        assert len(rounds) == 4
        assert multipass_cuda.launches[kernel] == rounds[0] + rounds[2] > 0


def test_server_requests_launch_one_kernel_each(cuda, tmp_path):
    """The server on the card: a BPE request launches one fused K2, a basic
    one one K1, passthrough, detokenize and an empty body none; every body
    equals the host engine's."""
    import http.client
    import threading

    from blt_tpu_torch import server

    merges = tmp_path / "m.txt"
    merges.write_text("97 98\n98 99\n97 97\n255 255\n")
    table = MergeTable.build({(97, 98): 256, (98, 99): 257, (97, 97): 258, (255, 255): 259})
    data = _text(70, 300_000)
    want = bpe_encode_flat(data, table).astype(">u2").tobytes()
    srv = server.make_server(port=0, merges_path=merges, engine="torch", warmup_bytes=1 << 17)
    plain = server.make_server(port=0, engine="torch")
    for s in (srv, plain):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    try:
        cases = [(srv, "/tokenize", data.tobytes(), "flat_bpe_packed", want),
                 (plain, "/tokenize", data.tobytes(), "widen", data.astype(">u2").tobytes()),
                 (srv, "/tokenize?mode=passthrough", data.tobytes(), None, data.tobytes()),
                 (srv, "/detokenize", want, None, data.tobytes()),
                 (srv, "/tokenize?type=text", b"", None, b"\xff\x01")]
        for s, path, body, kernel, expected in cases:
            bpe_cuda.reset_launches()
            conn = http.client.HTTPConnection(*s.server_address, timeout=120)
            conn.request("POST", path, body=body)
            r = conn.getresponse()
            assert r.status == 200 and r.read() == expected, path
            conn.close()
            counts = {k: v for k, v in bpe_cuda.launches.items() if v}
            assert counts == ({kernel: 1} if kernel else {}), (path, counts)
    finally:
        for s in (srv, plain):
            s.shutdown()
            s.server_close()


def test_warm_shapes_launch_each_modes_kernels(cuda, monkeypatch):
    from blt_tpu_torch.config import Mode
    from blt_tpu_torch.warmup import warm_shapes

    caps = [1 << 16, 1 << 20]
    bpe_cuda.reset_launches()
    assert warm_shapes(Mode.BASIC, None, caps, cuda) == 2
    assert warm_shapes(Mode.BPE, MergeTable.build(MERGES), caps, cuda) == 2
    assert warm_shapes(Mode.PASSTHROUGH, None, caps, cuda) == 0
    assert bpe_cuda.launches["widen"] == 2 and bpe_cuda.launches["flat_bpe_packed"] == 2
    for mode, kernel in (("gap", "token_pass_gap"), ("sort", "token_pass_lookback")):
        monkeypatch.setenv("BLT_MP_COMPACT", mode)
        multipass_cuda.reset_launches()
        assert warm_shapes(Mode.BPE, MergeTable.build(GENERAL), caps, cuda) == 2
        assert multipass_cuda.launches[kernel] >= 2


def test_learn_bpe_on_the_card_equals_the_cpu(cuda):
    from blt_tpu_torch.parallel import train

    data = _common.make_corpus(np.random.default_rng(19), 1 << 20)
    on_card = train.learn_bpe(data, 64, device=cuda)
    assert len(on_card) == 64
    assert list(on_card.items()) == list(train.learn_bpe(data, 64, device="cpu").items())
    batch = data.reshape(4, -1)
    lengths = np.array([1 << 18, 1 << 18, 1000, 0], np.int32)
    assert (list(train.learn_bpe_sharded(batch, lengths, 32, device=cuda).items())
            == list(train.learn_bpe_sharded(batch, lengths, 32, device="cpu").items()))


def test_learn_bpe_ties_break_toward_the_smallest_pair_on_the_card(cuda):
    """Two pairs occur three times each, the later one in the data with the
    smaller index, at the two ends of a 1.6e9-bin histogram."""
    from blt_tpu_torch.parallel import train

    num_merges = 39_744
    vocab = 256 + num_merges
    lo, hi = (1, 2), (vocab - 2, vocab - 1)
    seq = []
    for i in range(3):  # distinct separators: no other pair repeats
        seq += [*hi, 1000 + 2 * i, *lo, 1001 + 2 * i]
    tokens = np.array(seq, np.int32)
    t = torch.from_numpy(tokens).to(cuda)
    length = torch.tensor(tokens.shape[0], dtype=torch.int32, device=cuda)
    best, count, longest = train._best(train._count_pairs(t, length, vocab), length)
    assert (divmod(best, vocab), count, longest) == (lo, 3, tokens.shape[0])
    learned = list(train.learn_bpe(tokens, num_merges, device=cuda))
    assert learned[:2] == [lo, hi]


# the glue-only timing tools at 1-2 MiB: (module, bytes, k)
LOOP_TOOLS = {"exp_multipass": (exp_multipass, 2 << 20, 1), "exp_mp": (exp_mp, 1 << 20, 1),
              "exp_gap": (exp_gap, 1 << 20, 2), "exp_gapvar": (exp_gapvar, 1 << 20, 1),
              "exp_compact": (exp_compact, 1 << 20, 1), "exp_e2e": (exp_e2e, 2 << 20, 1),
              "exp_dense": (exp_dense, 1 << 20, 2), "exp_occ": (exp_occ, 1 << 20, 1)}


@pytest.mark.parametrize("name", sorted(LOOP_TOOLS))
def test_loop_tools_measure_exactly_on_the_card(cuda, name):
    module, size, k = LOOP_TOOLS[name]
    result = module.measure(cuda, size, k=k)
    assert result["exact"] is True and result["device"]["type"] == "cuda"
    assert all(row["exact"] for row in result["rows"])
