"""The port's multi-device layer against the JAX package's, on CPU rows.

``[cpu] * B`` rows (``blt_tpu_torch.parallel.mesh``) stand against a
B-device mesh of the 8 virtual CPU devices tests/conftest.py sets up, for
B in 1, 2, 3, 4 and 8. Both packages' tables are built from one merges
dict, inputs come from numpy ``default_rng(seed)``, and every comparison is
exact (tolerance 0: every value is an integer token):

- each function of ``parallel/sharded.py`` against ``blt_tpu.parallel
  .sharded``'s: tokens, counts, carry and histogram, on batches with empty,
  short and all-match rows;
- ``CudaShardedFlatEncoder.encode_batch``'s wire against the Pallas
  ``ShardedFlatEncoder`` in interpret mode followed by ``pack_slots_batch``,
  over each slab's payload; ``CudaShardedTokenEncoder`` against
  ``ShardedTokenEncoder`` in interpret mode under both loops;
- ``ShardedTorchEngine`` end to end against ``ShardedJaxEngine`` on the
  same mesh size and the oracle, and the halo stream's cases mirrored from
  tests/test_sharding.py (converging halos, the degenerate fallback, the
  pending-carry bridges in both directions, ``FF FF`` and merges across
  boundaries, short reads that carry across batches);
- ``TokenizerModel`` against the JAX model, and ``dryrun_multichip``.
"""

import io
import sys

import jax
import numpy as np
import pytest
import torch

from blt_tpu import merges as jax_merges
from blt_tpu.config import CoreConfig as JaxConfig
from blt_tpu.config import Engine as JaxEngineName
from blt_tpu.models.tokenizer import TokenizerModel as JaxTokenizerModel
from blt_tpu.ops import bpe_numpy as jax_numpy
from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
from blt_tpu.ops.bpe_pallas import ShardedFlatEncoder, ShardedTokenEncoder, pack_slots_batch
from blt_tpu.parallel import mesh as jax_mesh
from blt_tpu.parallel import sharded as jax_sharded
from blt_tpu.pipeline.engines import ShardedJaxEngine
from blt_tpu.pipeline.runner import run_tokenizer as jax_run_tokenizer
from blt_tpu_torch import cli
from blt_tpu_torch.config import CoreConfig, Engine
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.models.tokenizer import TokenizerModel
from blt_tpu_torch.ops import bpe_cuda, multipass_cuda
from blt_tpu_torch.ops.sharded_cuda import CudaShardedFlatEncoder, CudaShardedTokenEncoder
from blt_tpu_torch.parallel import distributed, dryrun, sharded
from blt_tpu_torch.parallel.mesh import make_mesh, replicated, row_sharding, vec_sharding
from blt_tpu_torch.pipeline import engines as torch_engines
from blt_tpu_torch.pipeline.engines import ShardedTorchEngine, select_engine
from blt_tpu_torch.pipeline.runner import run_tokenizer

CPU = torch.device("cpu")
ROWS = [1, 2, 3, 4, 8]
MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (97, 97): 259}
HIER = {(97, 98): 256, (256, 99): 257, (257, 257): 258, (100, 101): 259}


def _tables(merges):
    return MergeTable.build(merges), jax_merges.MergeTable.build(merges)


def _jax_mesh(b):
    return jax_mesh.make_mesh(jax.devices()[:b])


def _join(results) -> bytes:
    return b"".join(bytes(memoryview(r).cast("B")) for r in results)


def _data(seed, n, alphabet=b"abcabcaabbccaaaa"):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


def _batch(b, n, seed):
    """A (b, n) batch with stale bytes past each row's length: row 0 full,
    then an all-match row, a short row, an empty row and random rows."""
    rng = np.random.default_rng(seed)
    batch = _data(seed, b * n).reshape(b, n)
    lengths = rng.integers(0, n + 1, b).astype(np.int32)
    lengths[0] = n
    for r, kind in zip(range(1, b), ("allmatch", "short", "empty")):
        if kind == "allmatch":
            batch[r] = 97
            lengths[r] = n - 1
        elif kind == "short":
            lengths[r] = 3
        else:
            lengths[r] = 0
    return batch, lengths


def _jax_put(mesh, batch, lengths):
    return (jax.device_put(batch, jax_mesh.row_sharding(mesh)),
            jax.device_put(lengths, jax_mesh.vec_sharding(mesh)))


# --- parallel/mesh.py ------------------------------------------------------


def test_mesh_places_rows_on_their_devices():
    mesh = make_mesh([CPU] * 3)
    assert mesh == (CPU, CPU, CPU)
    batch = np.arange(12, dtype=np.uint8).reshape(3, 4)
    rows = row_sharding(mesh, batch)
    assert [r.tolist() for r in rows] == batch.tolist()
    assert [v.item() for v in vec_sharding(mesh, [5, 6, 7])] == [5, 6, 7]
    assert list(replicated(mesh, np.arange(3))) == [CPU]
    with pytest.raises(ValueError):
        row_sharding(mesh, batch[:2])


def test_mesh_and_shard_engine_need_cuda_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh, ShardedTorchEngine, lambda: select_engine("shard", 1 << 30)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_cli_engine_shard_without_cuda_exits_naming_cuda(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.bin"
    src.write_bytes(b"abcab" * 100)
    rc = cli.main(["-i", str(src), "-o", str(tmp_path / "o.bin"), "--engine", "shard"])
    assert rc == 1
    assert "CUDA" in capsys.readouterr().err
    assert Engine("shard") is Engine.SHARD


def test_probe_takes_every_card_of_a_multi_card_host(monkeypatch):
    made = []
    monkeypatch.setattr(torch_engines, "cuda_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch_engines, "ShardedTorchEngine", lambda **kw: made.append(kw) or "s")
    assert torch_engines._probe_device_engine(3) == "s" and made == [{"threads": 3}]


# --- parallel/sharded.py ---------------------------------------------------


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("carry_in,next_byte", [(False, -1), (True, 97)])
def test_sharded_flat_encode_matches_jax(b, carry_in, next_byte):
    table, jtable = _tables(MERGES)
    batch, lengths = _batch(b, 256, seed=b)
    mesh = _jax_mesh(b)
    jtok, jcount, jcarry = jax_sharded.sharded_flat_encode(
        *_jax_put(mesh, batch, lengths), jax.device_put(jtable.dense), carry_in, next_byte
    )
    pmesh = make_mesh([CPU] * b)
    tokens, counts, carry = sharded.sharded_flat_encode(
        row_sharding(pmesh, batch), lengths, replicated(pmesh, table.dense), carry_in, next_byte
    )
    assert np.stack([t.numpy() for t in tokens]).tolist() == np.asarray(jtok).tolist()
    assert counts.tolist() == np.asarray(jcount).tolist()
    assert bool(carry) == bool(jcarry)


@pytest.mark.parametrize("b", ROWS)
def test_sharded_flat_encode_threads_carry_like_one_sequence(b):
    """Batches of all-'a' rows chained through carry_out and the next
    batch's first byte give the single-sequence encode."""
    table, jtable = _tables({(97, 97): 256})
    corpus = np.full(3 * b * 64 - 1, 97, np.uint8)
    batches = [corpus[i : i + b * 64] for i in range(0, corpus.shape[0], b * 64)]
    pmesh = make_mesh([CPU] * b)
    carry, out = False, []
    for i, data in enumerate(batches):
        batch = np.zeros((b, 64), np.uint8)
        batch.reshape(-1)[: data.shape[0]] = data
        lengths = np.clip(data.shape[0] - 64 * np.arange(b), 0, 64).astype(np.int32)
        nxt = int(batches[i + 1][0]) if i + 1 < len(batches) else -1
        tokens, counts, carry = sharded.sharded_flat_encode(
            row_sharding(pmesh, batch), lengths, table.dense, carry, nxt
        )
        out += [t[:c].tolist() for t, c in zip(tokens, counts.tolist())]
    assert sum(out, []) == jax_numpy.bpe_encode_flat(corpus, jtable).tolist()


@pytest.mark.parametrize("b", ROWS)
def test_rowlocal_basic_and_histogram_match_jax(b):
    table, jtable = _tables(MERGES)
    batch, lengths = _batch(b, 128, seed=10 + b)
    mesh = _jax_mesh(b)
    batch_d, lengths_d = _jax_put(mesh, batch, lengths)
    pmesh = make_mesh([CPU] * b)
    rows = row_sharding(pmesh, batch)

    jtok, jcount = jax_sharded.sharded_flat_encode_rowlocal(
        batch_d, lengths_d, jax.device_put(jtable.dense))
    tokens, counts = sharded.sharded_flat_encode_rowlocal(rows, lengths, table.dense)
    assert np.stack([t.numpy() for t in tokens]).tolist() == np.asarray(jtok).tolist()
    assert counts.tolist() == np.asarray(jcount).tolist()

    bpe_cuda.reset_launches()
    widened = sharded.sharded_basic_encode(rows)
    assert bpe_cuda.launches["widen"] == 0  # the plain version on CPU rows
    jwide = np.asarray(jax_sharded.sharded_basic_encode(batch_d))
    assert np.stack([w.numpy() for w in widened]).tolist() == jwide.tolist()

    jhist = np.asarray(jax_sharded.pair_count_hist(batch_d, lengths_d))
    hist = sharded.pair_count_hist(rows, lengths)
    assert hist.tolist() == jhist.astype(np.int64).tolist()


# --- ops/sharded_cuda.py ---------------------------------------------------


def _slab_batch(enc, data, tail, next_byte=-1):
    """A batch laid out as the engine's halo stream lays it out."""
    h, p = enc.HALO, enc.payload
    batch = np.zeros((enc.n_rows, enc.padded_bytes), np.uint8)
    lengths = np.zeros(enc.n_rows, np.int32)
    next_bytes = np.full(enc.n_rows, -1, np.int32)
    metas, offset = [], 0
    for r in range(enc.n_rows):
        pl = min(p, data.shape[0] - offset)
        if pl <= 0:
            metas.append((0, 0))
            continue
        halo = tail[-h:] if r == 0 else data[max(0, offset - h) : offset]
        batch[r, : halo.shape[0]] = halo
        batch[r, halo.shape[0] : halo.shape[0] + pl] = data[offset : offset + pl]
        lengths[r] = halo.shape[0] + pl
        next_bytes[r] = data[offset + pl] if offset + pl < data.shape[0] else next_byte
        metas.append((halo.shape[0], pl))
        offset += pl
    return batch, lengths, next_bytes, metas


@pytest.mark.parametrize("b", [1, 3, 4])
def test_flat_encoder_wire_matches_pallas_then_pack(b):
    table, jtable = _tables({**MERGES, (255, 255): 0xFFFF})
    enc = CudaShardedFlatEncoder(table, [CPU] * b, capacity_bytes=2048)
    jenc = ShardedFlatEncoder(jtable, _jax_mesh(b), interpret=True, capacity_bytes=2048,
                              rows_per_block=8)
    assert (enc.capacity, enc.payload, enc.padded_bytes) == (jenc.capacity, jenc.payload, 2048)
    data = _data(20 + b, b * enc.payload - 37, b"abcabcaab\xff\xffz")
    tail = _data(30 + b, enc.HALO, b"zzab")
    batch, lengths, next_bytes, metas = _slab_batch(enc, data, tail, next_byte=98)
    bpe_cuda.reset_launches()
    wires, carries = enc.encode_batch(batch, lengths, next_bytes)
    assert bpe_cuda.launches["flat_bpe_packed"] == 0  # the plain version on CPU rows
    jbatch = np.zeros((b, jenc.padded_bytes), np.uint8)
    jbatch[:, : batch.shape[1]] = batch
    jslots, jcarry = jenc.encode_batch(jbatch, lengths, next_bytes)
    jwire = np.asarray(pack_slots_batch(jslots))
    cap = enc.capacity
    for r, (hl, pl) in enumerate(metas):
        w = wires[r].numpy()
        lo, hi = hl, hl + pl
        assert w[lo:hi].tolist() == jwire[r, lo:hi].tolist(), r
        bits = np.unpackbits(w[cap:], bitorder="little")[lo:hi]
        jbits = np.unpackbits(jwire[r, cap:], bitorder="little")[lo:hi]
        assert bits.tolist() == jbits.tolist(), r
        assert int(carries[r]) == int(np.asarray(jcarry)[r, 0, 0]), r


def test_flat_encoder_halo_rule_and_capacity():
    table, jtable = _tables(MERGES)
    allmatch = np.frombuffer(b"aa" * 600, np.uint8)
    mixed = np.frombuffer(b"aa" * 500 + b"zz" + b"aa" * 99, np.uint8)
    for halo in (allmatch, mixed, np.empty(0, np.uint8), allmatch[:1]):
        assert (CudaShardedFlatEncoder.halo_converges(table.dense, halo)
                == ShardedFlatEncoder.halo_converges(jtable.dense, halo))
    with pytest.raises(ValueError, match="halo"):
        CudaShardedFlatEncoder(table, [CPU] * 2, capacity_bytes=1536)


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("mode", ["gap", "sort"])
def test_token_encoder_matches_pallas_sharded(b, mode, monkeypatch):
    monkeypatch.setenv("BLT_MP_COMPACT", mode)
    table, jtable = _tables(HIER)
    rng = np.random.default_rng(23 + b)
    sizes = (2048, 1, 0, 700, 4096, 33, 999, 2)[:b]
    chunks = [rng.choice(np.frombuffer(b"abcabcde", np.uint8), size=s).astype(np.uint8)
              for s in sizes]
    enc = CudaShardedTokenEncoder(table, [CPU] * b, capacity_tokens=4096)
    jenc = ShardedTokenEncoder(jtable, _jax_mesh(b), interpret=True, capacity_tokens=4096,
                               rows_per_block=8)
    multipass_cuda.reset_launches()
    resident = enc.encode_batch_resident(chunks)
    assert len(multipass_cuda.loop_log) == b  # one device-resident loop a row
    jresident = jenc.encode_batch_resident(chunks)
    host = enc.encode_batch(chunks)
    for chunk, got, jgot, hgot in zip(chunks, resident, jresident, host):
        want = list(bpe_encode_oracle(chunk.tobytes(), HIER))
        assert got.tolist() == jgot.tolist() == hgot.tolist() == want, chunk.shape
    with pytest.raises(ValueError):
        enc.encode_batch(chunks + [chunks[0]] * (b + 1 - len(chunks)))


def test_token_encoder_pass_matches_pallas_sharded():
    table, jtable = _tables(HIER)
    rows = [np.frombuffer(b"abcabcabab", np.uint8).astype(np.int32),
            np.frombuffer(b"ababde", np.uint8).astype(np.int32)]
    enc = CudaShardedTokenEncoder(table, [CPU] * 2, capacity_tokens=1024)
    jenc = ShardedTokenEncoder(jtable, _jax_mesh(2), interpret=True, capacity_tokens=1024,
                               rows_per_block=8)
    got = enc.encode_pass_batch(rows)
    want = jenc.encode_pass_batch(rows)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


# --- pipeline/engines.py: ShardedTorchEngine -------------------------------


def _engines(b):
    return ShardedTorchEngine([CPU] * b), ShardedJaxEngine(mesh=_jax_mesh(b))


@pytest.mark.parametrize("b", ROWS)
def test_engine_matches_sharded_jax_engine(b, monkeypatch):
    table, jtable = _tables(MERGES)
    port, jeng = _engines(b)
    basic_rows = []  # the non-empty rows each basic batch encodes
    basic = torch_engines.sharded_basic_encode
    monkeypatch.setattr(torch_engines, "sharded_basic_encode",
                        lambda rows: basic_rows.append(len(rows)) or basic(rows))
    data = _data(40 + b, 9000)
    hint = 2048
    chunks = [data[i : i + hint] for i in range(0, data.shape[0], hint)]
    assert _join(port.basic_stream(iter(chunks), hint)) == _join(
        jeng.basic_stream(iter(chunks), hint)) == data.astype(">u2").tobytes()
    assert _join(port.passthrough_stream(iter(chunks), hint)) == data.tobytes()
    flat = _join(port.bpe_stream(iter(chunks), table, hint))
    assert flat == _join(jeng.bpe_stream(iter(chunks), jtable, hint))
    assert flat == tokens_to_be_bytes(bpe_encode_oracle(data.tobytes(), MERGES))
    assert sum(basic_rows) == -(-data.shape[0] // port._row_bytes(hint))


@pytest.mark.parametrize("b", [1, 3, 8])
def test_engine_hierarchical_routes_match_jax_and_oracle(b, monkeypatch):
    table, jtable = _tables(HIER)
    port, jeng = _engines(b)
    rng = np.random.default_rng(50 + b)
    chunks = [rng.choice(np.frombuffer(b"abcabcdeabc", np.uint8), size=s).astype(np.uint8)
              for s in (1200, 1, 2048, 33, 999, 2, 640, 0, 1500)]
    want = b"".join(tokens_to_be_bytes(bpe_encode_oracle(c.tobytes(), HIER)) for c in chunks)
    assert _join(jeng.bpe_stream(iter(chunks), jtable, 2048)) == want
    for mode in ("gap", "sort"):
        # the engine's route: each CPU row runs the loop's plain version
        monkeypatch.setenv("BLT_MP_COMPACT", mode)
        multipass_cuda.reset_launches()
        got = _join(port.bpe_stream(iter(chunks), table, 2048))
        assert got == want, mode
        assert len(multipass_cuda.loop_log) == sum(1 for c in chunks if c.shape[0])
    monkeypatch.setenv("BLT_MULTIPASS", "xla")  # the plain-torch twin a row
    assert _join(port.bpe_stream(iter(chunks), table, 2048)) == want


def test_engine_flat_table_below_256_takes_the_carry_stream(monkeypatch):
    merges = {(97, 98): 100, (98, 99): 257}  # a value < 256: K2 rejects it
    table, _ = _tables(merges)
    port = ShardedTorchEngine([CPU] * 3)
    carried = []
    carry_stream = port._bpe_flat_carry_stream
    monkeypatch.setattr(port, "_bpe_flat_carry_stream",
                        lambda *a: carried.append(1) or carry_stream(*a))
    data = _data(60, 5000, b"abcab")
    chunks = [data[i : i + 1024] for i in range(0, data.shape[0], 1024)]
    got = _join(port.bpe_stream(iter(chunks), table, 1024))
    assert got == tokens_to_be_bytes(bpe_encode_oracle(data.tobytes(), merges))
    assert carried == [1]


class TestHaloStream:
    """The halo stream's cases of tests/test_sharding.py (TestShardedFlatEncoder),
    on CPU rows, against the JAX package's flat encode."""

    def _run(self, b, table, chunks, hint, enc):
        port = ShardedTorchEngine([CPU] * b)
        wire = _join(port._bpe_flat_halo_stream(iter(chunks), table, enc, hint))
        return np.frombuffer(wire, ">u2").astype(np.int64).tolist(), port.counts

    @pytest.mark.parametrize("b", ROWS)
    def test_converging_halos(self, b):
        table, jtable = _tables(MERGES)
        enc = CudaShardedFlatEncoder(table, [CPU] * b, capacity_bytes=2048)
        corpus = _data(11, 33000, b"abcabcaabbccaaaa zqx")
        hint = enc.payload * enc.n_rows
        cuts = [0, hint, 2 * hint - 517, 3 * hint - 517, 4 * hint - 517, corpus.shape[0]]
        chunks = [corpus[a:z] for a, z in zip(cuts, cuts[1:])]
        got, counts = self._run(b, table, chunks, hint, enc)
        assert got == jax_numpy.bpe_encode_flat(corpus, jtable).tolist()
        assert counts["carry_batches"] == 0

    @pytest.mark.parametrize("b", ROWS)
    def test_degenerate_fallback(self, b):
        table, jtable = _tables(MERGES)
        enc = CudaShardedFlatEncoder(table, [CPU] * b, capacity_bytes=2048)
        hint = enc.payload * enc.n_rows
        corpus = np.concatenate([np.frombuffer(b"abc" * 400, np.uint8),
                                 np.frombuffer(b"aa" * 3000, np.uint8),
                                 np.frombuffer(b"cab" * 400, np.uint8)])
        chunks = [corpus[i : i + hint] for i in range(0, corpus.shape[0], hint)]
        got, counts = self._run(b, table, chunks, hint, enc)
        assert got == jax_numpy.bpe_encode_flat(corpus, jtable).tolist()
        assert counts["carry_batches"] >= 1

    @pytest.mark.parametrize("b", [2, 4, 8])
    def test_pending_carry_transitions(self, b):
        """A packed batch ends mid-merge into a degenerate batch (bridge rule
        2 prepends the lo byte), which ends mid-merge into a converging
        packed batch (bridge rule 1 skips the first position)."""
        table, jtable = _tables(MERGES)
        enc = CudaShardedFlatEncoder(table, [CPU] * b, capacity_bytes=2048)
        hint = enc.payload * enc.n_rows
        h = enc.HALO
        filler = np.frombuffer(b"zq" * ((hint - h - 1) // 2) + b"z", np.uint8)
        b0 = np.concatenate([filler, np.full(hint - filler.size, 97, np.uint8)])
        assert (hint - filler.size) >= h + 1 and (hint - filler.size) % 2 == 1
        b1 = np.frombuffer(b"a" * (hint - 2) + b"za", np.uint8)
        b2 = np.concatenate([np.frombuffer(b"a", np.uint8), filler[: 4096 - 1]])
        got, counts = self._run(b, table, [b0, b1, b2], hint, enc)
        want = jax_numpy.bpe_encode_flat(np.concatenate([b0, b1, b2]), jtable).tolist()
        assert got == want
        assert counts["carry_batches"] == 1  # exactly the middle batch

    @pytest.mark.parametrize("b", [1, 3, 8])
    def test_ffff_and_boundary_merges(self, b):
        merges = {(255, 255): 0xFFFF, (97, 98): 300, (98, 97): 301}
        table, jtable = _tables(merges)
        enc = CudaShardedFlatEncoder(table, [CPU] * b, capacity_bytes=2048)
        hint = enc.payload * enc.n_rows
        corpus = _data(5, 2 * hint + 77, b"ababbaz\xff\xff\xff")
        chunks = [corpus[i : i + hint] for i in range(0, corpus.shape[0], hint)]
        got, _ = self._run(b, table, chunks, hint, enc)
        assert got == jax_numpy.bpe_encode_flat(corpus, jtable).tolist()


def _short_stdin(monkeypatch, data, maxread):
    class ShortStdin:
        def __init__(self):
            self.buf = io.BytesIO(data)

        def read(self, n):
            return self.buf.read(min(n, maxread))

    monkeypatch.setattr(sys, "stdin", type("S", (), {"buffer": ShortStdin()})())


def test_runner_shard_engine_short_reads_carry(tmp_path, monkeypatch):
    """stdin with short reads: batches end in empty rows, and an all-'a'
    corpus passes a pending merge through them into the next batch."""
    data = b"a" * 300_001
    mp = tmp_path / "m.txt"
    mp.write_text("97 97\n")
    _short_stdin(monkeypatch, data, 70_001)
    out = tmp_path / "shard.bin"
    run_tokenizer(CoreConfig.new_from_cli(input=None, output=out, merges=mp),
                  engine=ShardedTorchEngine([CPU] * 8))
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    ref = tmp_path / "jax.bin"
    jax_run_tokenizer(JaxConfig.new_from_cli(input=src, output=ref, merges=mp,
                                             engine=JaxEngineName.NUMPY))
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("b", [2, 8])
def test_runner_files_match_jax_shard_engine(tmp_path, b):
    """File to file with a content-type header across several device
    batches (conftest: 256 KiB), against the JAX run on its 8-device mesh."""
    corpus = _data(11, 700_001).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(corpus)
    mp = tmp_path / "m.txt"
    mp.write_text("97 98\n98 99\n99 97\n97 97\n")
    for merges in (None, mp):
        ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
        run_tokenizer(CoreConfig.new_from_cli(input=src, output=ours, merges=merges,
                                              content_type=None),
                      engine=ShardedTorchEngine([CPU] * b))
        jax_run_tokenizer(JaxConfig.new_from_cli(input=src, output=theirs, merges=merges,
                                                 engine=JaxEngineName.SHARD))
        assert ours.read_bytes() == theirs.read_bytes(), merges


# --- models, dry run, solo distributed state -------------------------------


def test_tokenizer_model_matches_jax():
    rng = np.random.default_rng(0)
    merges = {}
    for _ in range(200):
        key = (int(rng.integers(0, 256)), int(rng.integers(0, 256)))
        merges.setdefault(key, 256 + len(merges))
    table, jtable = _tables(merges)
    model = TokenizerModel(table, device=CPU)
    jmodel = JaxTokenizerModel(jtable)
    assert isinstance(model, torch.nn.Module) and "dense" in dict(model.named_buffers())
    for n, seed in ((65536, 0), (4096, 3)):
        args = model.example_args(n, seed)
        jargs = jmodel.example_args(n, seed)
        assert args[0].numpy().tolist() == np.asarray(jargs[0]).tolist()
        for carry, nxt in ((False, -1), (True, 97)):
            toks, count, carry_out, be = model(args[0], n, torch.tensor(carry), nxt)
            jtoks, jcount, jcarry, jbe = jmodel.forward(
                jargs[0], jargs[1], np.bool_(carry), np.int32(nxt))
            assert toks.tolist() == np.asarray(jtoks).tolist()
            assert int(count) == int(jcount) and bool(carry_out) == bool(jcarry)
            assert be.numpy().tobytes() == np.asarray(jbe).tobytes()
    with pytest.raises(ValueError, match="flat"):
        TokenizerModel(MergeTable.build(HIER), device=CPU)


def test_dryrun_multichip_on_cpu_rows(capsys):
    dryrun.dryrun_multichip(4, devices=[CPU] * 4)
    assert "dryrun_multichip OK: 4 rows" in capsys.readouterr().out


def test_distributed_argless_is_solo(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(distributed, "_init_state", None)
    distributed.initialize()
    assert distributed._init_state == "solo"
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.host_byte_range(10) == (0, 10)
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("127.0.0.1:1")
