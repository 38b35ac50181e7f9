"""The torch port's kernel modules against the JAX package, on the CPU.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode, as
tests/test_pallas.py does. Every comparison is exact (tolerance 0): every
value is an integer token, slot, carry or wire byte. Inputs come from
numpy ``default_rng(seed)``. The CUDA kernels themselves are held against
the plain versions by tests/test_torch_gpu.py and by ``chip_smoke.py``.

Slots are compared over the ``n`` valid positions: past ``n`` the Pallas
kernel's padding blocks take the block carry into their first slot (an
artefact of its sequential grid), and nothing reads slots past ``n``.
The packed wire's flag plane is compared whole.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_tpu.merges import NO_RULE, MergeTable
from blt_tpu.ops import bpe_jax
from blt_tpu.ops.bpe_numpy import bpe_encode_flat
from blt_tpu.ops.bpe_pallas import (
    PallasBasicEncoder,
    PallasFlatEncoder,
    basic_encode_pallas,
)
from blt_tpu.ops.bpe_pallas import unpack_slots_host as jax_unpack_slots_host
from blt_tpu_torch.ops import bpe_cuda, bpe_torch
from blt_tpu_torch.ops.tables import state_from_jax, wire_table

RPB = 8  # Pallas rows per block: 1024-byte blocks, so a few KiB is multi-block
CAP = 4096
CPU = torch.device("cpu")
MODES = ("perfect", "chd", "cuckoo", "direct")


def _table(n_rules, seed, extra=()):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(65536)[:n_rules]
    pairs = [(int(k) // 256, int(k) % 256) for k in keys] + list(extra)
    return MergeTable.build({p: 256 + i for i, p in enumerate(dict.fromkeys(pairs))})


# one table per lookup mode, each buildable in that mode
def _mode_table(mode):
    if mode == "perfect":
        return MergeTable.build(
            {(97, 97): 256, (97, 98): 257, (255, 0): 258, (255, 255): 0xFFFF}
        )
    return _table(500, seed=7, extra=[(97, 97), (97, 98), (255, 0), (255, 255)])


def _pallas(table, mode, capacity=CAP):
    enc = PallasFlatEncoder(
        table, interpret=True, capacity_bytes=capacity, rows_per_block=RPB,
        force_mode=mode,
    )
    assert enc.mode == mode
    return enc


def _port(table, capacity=CAP):
    return bpe_cuda.CudaFlatEncoder(table, CPU, capacity_bytes=capacity)


def _text(rng, n, alphabet=b"aabbcc \xff\x00ab"):
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).astype(np.uint8)


# --- K1 widen ---------------------------------------------------------------


def test_widen_plain_equals_pallas_and_xla():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (32, 128)).astype(np.uint8)
    pallas, _ = basic_encode_pallas(jnp.asarray(data), interpret=True, rows_per_block=RPB)
    xla = bpe_jax.basic_encode(jnp.asarray(data))
    got = bpe_cuda.basic_encode(torch.from_numpy(data))
    assert got.dtype == torch.uint16 and got.shape == (32, 128)
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    assert np.array_equal(got.numpy(), np.asarray(xla))
    assert np.array_equal(bpe_torch.basic_encode(torch.from_numpy(data)).numpy(), np.asarray(xla))
    assert bpe_cuda.launches["widen"] == 0  # plain versions are not launches


def test_basic_encoder_matches_pallas_encoder():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 3000).astype(np.uint8)
    jax_enc = PallasBasicEncoder(CAP, interpret=True, rows_per_block=RPB)
    port = bpe_cuda.CudaBasicEncoder(CAP, CPU)
    assert port.capacity == jax_enc.capacity == port.padded_bytes
    j_out, jn = jax_enc.encode(data)
    p_out, pn = port.encode(data)
    assert jn == pn == 3000
    assert tuple(p_out.shape) == np.asarray(j_out).shape
    assert np.array_equal(p_out.numpy(), np.asarray(j_out))
    buf = np.full(port.padded_bytes, 0xEE, np.uint8)
    dev, n = port.upload(data, buf)
    assert np.array_equal(port.encode_device(dev, n)[0].numpy().reshape(-1)[:n],
                          np.asarray(j_out).reshape(-1)[:n])


# --- K2 flat pass -----------------------------------------------------------


def _edge_cases(rng):
    """(name, data, n, next_byte, carry) over a CAP-byte buffer with a
    stale tail of matching bytes past n."""
    text = _text(rng, CAP)
    run = np.full(CAP, 97, np.uint8)  # (97,97): a parity chain across blocks
    ff = rng.choice(np.array([255, 255, 255, 97], np.uint8), CAP)
    cases = [
        ("full", text, CAP, -1, 0),
        ("stale_tail", text, 2500, int(text[2500]), 0),
        ("run_c0", run, CAP - 3, 97, 0),
        ("run_c1", run, CAP - 3, 97, 1),
        ("ff_runs", ff, CAP, -1, 1),
        ("n1", text, 1, int(text[1]), 1),
        ("n1_eof", text, 1, -1, 0),
        ("n0", text, 0, -1, 1),
    ]
    for nb in (-1, 0, 255):
        for carry in (0, 1):
            tail = text.copy()
            tail[2999] = 255  # rules (255, 0) and (255, 255) pair it with nb
            cases.append((f"next{nb}_c{carry}", tail, 3000, nb, carry))
    return cases


@pytest.mark.parametrize("mode", MODES)
def test_flat_pass_equals_pallas_in_every_lookup_mode(mode):
    table = _mode_table(mode)
    jax_enc = _pallas(table, mode)
    port = _port(table)
    wt = wire_table(table.dense)
    rng = np.random.default_rng(3)
    for name, data, n, nb, carry in _edge_cases(rng):
        jbuf = np.zeros(jax_enc.padded_bytes, np.uint8)
        jbuf[:CAP] = data
        j_slots, _, j_carry = jax_enc.encode_device(
            jnp.asarray(jbuf.reshape(-1, 128)), n, carry, nb
        )
        j_slots = np.asarray(j_slots).reshape(-1)
        j_carry = np.asarray(j_carry)

        # the encoder (device "cpu") and the bare plain version
        p_slots, pn, p_carry = port.encode_device(torch.from_numpy(data.copy()), n, carry, nb)
        assert pn == n and tuple(p_slots.shape) == (CAP // 128, 128)
        assert p_slots.dtype == torch.uint16 and tuple(p_carry.shape) == (1, 1)
        plain, plain_carry = bpe_cuda.flat_pass_plain(
            torch.from_numpy(data.copy()), n, nb, wt, torch.tensor([carry], dtype=torch.int32)
        )
        for slots, c in ((p_slots.reshape(-1), p_carry), (plain, plain_carry)):
            assert np.array_equal(slots.numpy()[:n], j_slots[:n]), (mode, name)
            assert c.numpy().tolist() == j_carry.tolist(), (mode, name)


def test_fifty_k_rule_table_direct_mode():
    rng = np.random.default_rng(4)
    codes = rng.permutation(65536)[:50_000]
    table = MergeTable.build({(int(k) // 256, int(k) % 256): 256 + i for i, k in enumerate(codes)})
    jax_enc = PallasFlatEncoder(table, interpret=True, capacity_bytes=CAP, rows_per_block=RPB)
    assert jax_enc.mode == "direct"
    port = _port(table)
    data = rng.integers(0, 256, CAP).astype(np.uint8)
    for n, nb, carry in ((CAP, -1, 0), (3001, int(data[3001]), 1)):
        j_slots, _, j_carry = jax_enc.encode(data[:n], carry, nb)
        p_slots, _, p_carry = port.encode(data[:n], carry, nb)
        assert np.array_equal(p_slots.numpy().reshape(-1)[:n], np.asarray(j_slots).reshape(-1)[:n])
        assert p_carry.numpy().tolist() == np.asarray(j_carry).tolist()


def _packed_run(enc, pieces, buf, carry, prev, on_port):
    """Upload and encode_packed_device over chained pieces; returns the
    per-batch (wire, carry, last_slot) as numpy and the final state."""
    out = []
    for j, piece in enumerate(pieces):
        nb = int(pieces[j + 1][0]) if j + 1 < len(pieces) else -1
        dev, n = enc.upload(piece, buf)
        wire, carry, prev = enc.encode_packed_device(dev, n, carry, nb, prev)
        as_np = (lambda t: t.numpy()) if on_port else np.asarray
        out.append((n, as_np(wire), as_np(carry), as_np(prev)))
    return out, carry, prev


def _expand(batches, cap):
    return b"".join(
        jax_unpack_slots_host(w[:cap], w[cap:], n).tobytes() for n, w, _, _ in batches
    )


@pytest.mark.parametrize("mode", ["chd", "direct"])
def test_packed_wire_and_last_slot_equal_pallas_over_chained_batches(mode):
    table = _mode_table(mode)
    jax_enc = _pallas(table, mode)
    port = _port(table)
    rng = np.random.default_rng(5)
    data = _text(rng, 4 * CAP)
    data[:1500] = 97  # a run that crosses the first batch boundary
    cuts = [0, CAP, CAP + 1, 2 * CAP - 7, 3 * CAP - 7, 4 * CAP - 7, 4 * CAP]
    pieces = [data[a:b] for a, b in zip(cuts, cuts[1:])]
    # both upload buffers start with the same stale bytes
    stale = _text(rng, jax_enc.padded_bytes)
    jb, _, _ = _packed_run(jax_enc, pieces, stale.copy(), False, jnp.int32(0), False)
    pb, _, _ = _packed_run(port, pieces, stale[: port.padded_bytes].copy(), False, 0, True)
    for (n, jw, jc, jl), (pn, pw, pc, pl) in zip(jb, pb):
        assert n == pn and pw.shape == jw.shape == (CAP + CAP // 8,)
        assert np.array_equal(pw[:n], jw[:n])
        assert np.array_equal(pw[CAP:], jw[CAP:])  # the whole flag plane
        assert pc.tolist() == jc.tolist() and int(pl) == int(jl)
    expected = bpe_encode_flat(data, table).astype(">u2").tobytes()
    assert _expand(pb, CAP) == expected == _expand(jb, CAP)


def test_state_from_jax_continues_a_jax_stream():
    """Batches started in JAX and finished in the port equal a run done
    entirely in either package."""
    table = _mode_table("chd")
    jax_enc = _pallas(table, "chd")
    port = _port(table)
    rng = np.random.default_rng(6)
    data = _text(rng, 4 * CAP, alphabet=b"aaab")
    pieces = [data[i : i + CAP] for i in range(0, data.shape[0], CAP)]
    jbuf = np.zeros(jax_enc.padded_bytes, np.uint8)
    pbuf = np.zeros(port.padded_bytes, np.uint8)
    all_jax, _, _ = _packed_run(jax_enc, pieces, jbuf, False, jnp.int32(0), False)
    all_port, _, _ = _packed_run(port, pieces, pbuf, False, 0, True)
    head, j_carry, j_prev = _packed_run(jax_enc, pieces[:2], jbuf, False, jnp.int32(0), False)
    carry, prev = state_from_jax(j_carry, j_prev)
    assert carry.dtype == prev.dtype == torch.int32
    assert tuple(carry.shape) == (1, 1) and tuple(prev.shape) == ()
    # the tail is encoded with pieces[2:] plus the next-byte halo intact
    tail = []
    for j in (2, 3):
        nb = int(pieces[j + 1][0]) if j + 1 < len(pieces) else -1
        dev, n = port.upload(pieces[j], pbuf)
        wire, carry, prev = port.encode_packed_device(dev, n, carry, nb, prev)
        tail.append((n, wire.numpy(), carry.numpy(), prev.numpy()))
    mixed = _expand(head + tail, CAP)
    assert mixed == _expand(all_jax, CAP) == _expand(all_port, CAP)
    assert mixed == bpe_encode_flat(data, table).astype(">u2").tobytes()


# --- tables -----------------------------------------------------------------


def test_wire_table_byteswaps_and_maps_no_rule_to_zero():
    table = MergeTable.build({(255, 255): 0xFFFF, (97, 98): 0x0102, (0, 0): 0x1234})
    wt = wire_table(table.dense)
    assert wt.dtype == torch.uint16 and tuple(wt.shape) == (65536,)
    got = wt.numpy().astype(np.int64)
    assert got[0xFFFF] == 0xFFFF  # an ordinary value, not a sentinel
    assert got[97 * 256 + 98] == 0x0201
    assert got[0] == 0x3412
    assert np.count_nonzero(got) == 3
    assert (table.dense == NO_RULE).sum() == 65536 - 3


def test_wire_table_rejects_values_below_256():
    with pytest.raises(ValueError, match="256"):
        wire_table(MergeTable.build({(120, 121): 90}).dense)
    with pytest.raises(ValueError, match="65536"):
        wire_table(np.zeros(10, np.int32))


def test_ffff_rule_present_and_absent_through_the_port():
    rng = np.random.default_rng(8)
    data = rng.choice(np.array([255, 255, 97, 98], np.uint8), 3000)
    for merges in ({(255, 255): 0xFFFF, (97, 98): 256}, {(97, 98): 256}):
        table = MergeTable.build(merges)
        slots, n, _ = _port(table).encode(data, 0, -1)
        toks, _ = bpe_cuda.filter_slots(slots.numpy().reshape(-1)[:n], 0)
        got = np.frombuffer(toks.tobytes(), ">u2").astype(np.int64)
        assert got.tolist() == bpe_encode_flat(data, table).tolist()
        assert (0xFFFF in got.tolist()) == ((255, 255) in merges)


# --- bpe_torch (the twin route) ---------------------------------------------


@pytest.mark.parametrize(
    "merges",
    [{(97, 98): 256, (98, 99): 257, (99, 97): 258}, {(97, 98): 90, (98, 97): 7}],
)
def test_bpe_torch_flat_encode_equals_bpe_jax(merges):
    table = MergeTable.build(merges)
    rng = np.random.default_rng(9)
    buf = _text(rng, 2048, alphabet=b"abcab")
    dense_j = bpe_jax.dense_table_device(table)
    dense_t = torch.from_numpy(table.dense)
    for length, carry, nb in ((2048, False, -1), (1500, True, 97), (1, True, 98), (0, False, -1)):
        j = bpe_jax.flat_encode(
            jnp.asarray(buf), jnp.int32(length), dense_j, jnp.asarray(carry), jnp.int32(nb)
        )
        t = bpe_torch.flat_encode(
            torch.from_numpy(buf.copy()), length, dense_t, torch.tensor(carry), nb
        )
        assert np.array_equal(t[0].numpy(), np.asarray(j[0]))
        assert int(t[1]) == int(j[1])
        assert bool(t[2]) == bool(j[2])
        assert np.array_equal(t[3].numpy(), np.asarray(j[3]))
    toks = np.arange(70000, dtype=np.int32) % 65536
    assert np.array_equal(
        bpe_torch.tokens_to_be_bytes_device(torch.from_numpy(toks)).numpy(),
        np.asarray(bpe_jax.tokens_to_be_bytes_device(jnp.asarray(toks))),
    )


# --- dispatch -----------------------------------------------------------------


def test_wrappers_dispatch_on_the_tensor_device_only():
    table = wire_table(_mode_table("chd").dense)
    data = torch.zeros(CAP, dtype=torch.uint8)
    carry = torch.zeros((1, 1), dtype=torch.int32)
    bpe_cuda.reset_launches()
    bpe_cuda.flat_encode_slots(data, CAP, -1, table, carry)
    bpe_cuda.pack_slots(torch.zeros(CAP, dtype=torch.uint16), CAP, carry.reshape(()))
    bpe_cuda.basic_encode(data)
    assert {"widen", "flat_bpe", "pack_slots", "basic_chained"} <= set(bpe_cuda.launches)
    assert all(v == 0 for v in bpe_cuda.launches.values())
    with pytest.raises(ValueError, match="CUDA or all-CPU"):
        bpe_cuda.basic_encode(data.to("meta"))
    with pytest.raises(ValueError, match="does not fit"):
        bpe_cuda.flat_encode_slots(data, CAP + 1, -1, table, carry)
    with pytest.raises(ValueError, match="next_byte"):
        bpe_cuda.flat_encode_slots(data, CAP, 256, table, carry)
    with pytest.raises(ValueError, match="drop-after-merge"):
        bpe_cuda.CudaFlatEncoder(MergeTable.build({(1, 2): 9}), CPU)
