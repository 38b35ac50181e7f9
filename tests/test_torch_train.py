"""The port's BPE merge training against the JAX package's, on the CPU.

Every comparison is exact (tolerance 0: token ids, counts and rules are
integers). Inputs are made from seeds with numpy.

- ``_count_pairs`` (one sequence and (B, N) rows), ``_apply_one_rule``
  (tokens, the zero tail and the count) and ``_check_vocab``;
- ``learn_bpe`` and ``learn_bpe_sharded``: the dicts equal, in order, ties
  included;
- ``save_merges``: the same text;
- checkpoints: the same ``.npz`` arrays at the same step, and a checkpoint
  of either trainer resumes in the other to the other's clean result;
- the train CLI as a process (``--device cpu``): the JAX CLI's tests, its
  output file equal to ``blt_tpu.train_cli``'s, and exit 1 naming CUDA
  without a card.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blt_tpu.parallel import train as jax_train
from blt_tpu_torch.merges import load_bpe_merges_from_path
from blt_tpu_torch.parallel import train
from blt_tpu_torch.tools._common import make_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
CKPT_KEYS = ("keys", "vals", "new_id", "tokens", "lengths")


def _small_alphabet(seed=3, n=3000):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"aab cab", np.uint8), size=n).astype(np.uint8)


CORPORA = {
    "cat": lambda: b"the cat sat on the mat " * 50,
    "zipf_64k": lambda: make_corpus(np.random.default_rng(19), 64 * 1024).tobytes(),
    "small_alphabet": lambda: _small_alphabet().tobytes(),
    # (120,121), (121,32), (32,97) and (97,98) occur 3 times each: the
    # winner is (32, 97), the smallest index, not the first in the data
    "ties": lambda: b"xy xy xy ab ab ab",
    "no_repeated_pair": lambda: bytes(range(256)),
}


# --- the steps ------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [256, 300, 1000])
@pytest.mark.parametrize("which", ["0", "1", "2", "n-1", "n"])
def test_count_pairs_matches_jax(vocab, which):
    n = 97
    length = {"0": 0, "1": 1, "2": 2, "n-1": n - 1, "n": n}[which]
    rng = np.random.default_rng(vocab * 1000 + length)
    tokens = rng.integers(0, vocab, n).astype(np.int32)
    tokens[length:] = rng.integers(-(2**31), 2**31 - 1, n - length)  # garbage
    want = np.asarray(jax_train._count_pairs(jnp.asarray(tokens), jnp.int32(length), vocab))
    got = train._count_pairs(torch.from_numpy(tokens), length, vocab).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_count_pairs_sharded_matches_jax():
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 300, (4, 50)).astype(np.int32)
    lengths = np.array([50, 0, 1, 23], np.int32)
    tokens[3, 23:] = 7777  # garbage past the row
    want = np.asarray(jax_train._count_pairs_sharded(jnp.asarray(tokens), jnp.asarray(lengths),
                                                     300))
    got = train._count_pairs_sharded(torch.from_numpy(tokens), torch.from_numpy(lengths), 300)
    np.testing.assert_array_equal(got.numpy(), want)


APPLY_CASES = {
    "run_of_aa": ([5, 5, 5, 5, 5, 7, 5, 5, 5, 5], 10, 5, 5),
    "pair_at_the_last_valid_position": ([1, 2, 3, 4, 1, 2], 6, 1, 2),
    "pair_across_length": ([3, 1, 2, 1, 2, 9, 9], 4, 1, 2),
    "length_below_n": ([1, 2, 1, 2, 1, 2, 1, 2], 5, 2, 1),
    "a_equals_b_runs": ([3, 3, 3, 0, 3, 3, 3, 3, 3, 1, 3, 3], 12, 3, 3),
    "length_1": ([4, 4, 4], 1, 4, 4),
    "length_0": ([4, 4, 4], 0, 4, 4),
    "no_match": ([1, 2, 3], 3, 2, 1),
}


def _apply_both(tokens, length, a, b, new_id=300):
    t = np.asarray(tokens, np.int32)
    jo, jc = jax_train._apply_one_rule(jnp.asarray(t), jnp.int32(length), jnp.int32(a),
                                       jnp.int32(b), jnp.int32(new_id))
    po, pc = train._apply_one_rule(torch.from_numpy(t), torch.tensor(length, dtype=torch.int32),
                                   a, b, new_id)
    return (np.asarray(jo), int(jc)), (po.numpy(), int(pc))


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_apply_one_rule_matches_jax(case):
    (want, want_count), (got, got_count) = _apply_both(*APPLY_CASES[case])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)  # the zero tail included
    assert got_count == want_count
    assert not got[got_count:].any()


@pytest.mark.parametrize("seed", range(6))
def test_apply_one_rule_matches_jax_on_random_rows(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        n = int(rng.integers(1, 60))
        tokens = rng.integers(0, 3, n)
        a, b = (int(v) for v in rng.integers(0, 3, 2))
        (want, want_count), (got, got_count) = _apply_both(tokens, int(rng.integers(0, n + 1)),
                                                           a, b)
        np.testing.assert_array_equal(got, want)
        assert got_count == want_count


def test_apply_one_rule_rows_keeps_short_and_empty_rows():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 2, (4, 16)).astype(np.int32)
    lengths = np.array([16, 0, 1, 9], np.int32)
    jo, jc = jax_train._apply_one_rule_rows(jnp.asarray(tokens), jnp.asarray(lengths),
                                            jnp.int32(0), jnp.int32(1), jnp.int32(256))
    po, pc = train._apply_one_rule_rows(torch.from_numpy(tokens), torch.from_numpy(lengths),
                                        0, 1, 256)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def test_best_reads_the_first_maximum_and_the_longest_row():
    hist = torch.zeros(1000, dtype=torch.int32)
    hist[[17, 500, 999]] = 5
    assert train._best(hist, torch.tensor([3, 40, 7], dtype=torch.int32)) == (17, 5, 40)
    assert train._best(hist, torch.tensor(12, dtype=torch.int32)) == (17, 5, 12)


@pytest.mark.parametrize("shape", [(0,), (1,), (257,), (3, 64), (2, 0)])
def test_last_nonmatch_equals_the_cummax_of_the_sentinel(shape):
    """The JAX trainer's ``cummax(where(match, _NEG_INF32, idx))``."""
    rng = np.random.default_rng(sum(shape))
    for density in (0.0, 0.5, 0.9, 1.0):
        match = torch.from_numpy(rng.random(shape) < density)
        idx = torch.arange(shape[-1], dtype=torch.int32).expand(shape)
        want = torch.cummax(torch.where(match, train._NEG_INF32, idx), dim=-1).values
        got = train._last_nonmatch(match)
        assert got.dtype == torch.int32
        assert torch.equal(got, want), density


def test_check_vocab_matches_jax():
    assert train._check_vocab(46084) == jax_train._check_vocab(46084) == 46340
    with pytest.raises(ValueError) as port_err:
        train._check_vocab(46085)
    with pytest.raises(ValueError) as jax_err:
        jax_train._check_vocab(46085)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="num_merges <= 46084"):
        train.learn_bpe(b"abab", 46085, device=CPU)


# --- the trainers ------------------------------------------------------------


@pytest.mark.parametrize("num_merges", [0, 1, 8, 40])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_learn_bpe_matches_jax(corpus, num_merges):
    data = CORPORA[corpus]()
    got = train.learn_bpe(data, num_merges, device=CPU)
    want = jax_train.learn_bpe(data, num_merges)
    assert list(got.items()) == list(want.items())
    if corpus == "ties" and num_merges:
        assert next(iter(got)) == (32, 97)
    if corpus == "no_repeated_pair":
        assert got == {}


def _rows(b, seed=4):
    """(B, N) rows of a small-alphabet corpus with a short and, from B = 3,
    an empty row."""
    rng = np.random.default_rng(seed + b)
    n = 400
    batch = rng.choice(np.frombuffer(b"aab cab", np.uint8), size=(b, n)).astype(np.uint8)
    lengths = np.full(b, n, np.int32)
    if b > 1:
        lengths[-1] = 37
    if b > 2:
        lengths[1] = 0
        batch[1] = 0
    return batch, lengths


@pytest.mark.parametrize("b", [1, 3, 4])
def test_learn_bpe_sharded_matches_jax(b):
    batch, lengths = _rows(b)
    got = train.learn_bpe_sharded(batch, lengths, 24, device=CPU)
    want = jax_train.learn_bpe_sharded(batch, lengths, 24)
    assert list(got.items()) == list(want.items())
    assert len(got) == 24


def test_save_merges_text_equals_jax(tmp_path):
    merges = train.learn_bpe(CORPORA["cat"](), 40, device=CPU)
    assert any(a >= 256 or b >= 256 for a, b in merges)  # hierarchical rules too
    train.save_merges(merges, tmp_path / "port.txt")
    jax_train.save_merges(merges, tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


# --- checkpoints ------------------------------------------------------------


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in CKPT_KEYS}


@pytest.mark.parametrize("num_merges", [3, 7])
def test_checkpoints_equal_jax_at_the_same_step(tmp_path, num_merges):
    batch, lengths = _rows(3)
    port_path, jax_path = tmp_path / "port.npz", tmp_path / "jax.npz"
    train.learn_bpe_sharded(batch, lengths, num_merges, checkpoint_path=str(port_path),
                            checkpoint_every=3, device=CPU)
    jax_train.learn_bpe_sharded(batch, lengths, num_merges, checkpoint_path=str(jax_path),
                                checkpoint_every=3)
    got, want = _load(port_path), _load(jax_path)
    for k in CKPT_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # load_checkpoint converts either file to the same numpy state
    for path in (port_path, jax_path):
        m1, id1, t1, l1 = train.load_checkpoint(path)
        m2, id2, t2, l2 = jax_train.load_checkpoint(path)
        assert list(m1.items()) == list(m2.items()) and id1 == id2 == 256 + num_merges
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(l1, l2)
    assert sorted(os.listdir(tmp_path)) == ["jax.npz", "port.npz"]  # no .tmp. left


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    batch, lengths = _rows(4)
    ckpt = str(tmp_path / "state.npz")
    jax_train.learn_bpe_sharded(batch, lengths, 5, checkpoint_path=ckpt, checkpoint_every=2)
    got = train.learn_bpe_sharded(batch, lengths, 14, checkpoint_path=ckpt, checkpoint_every=2,
                                  resume=True, device=CPU)
    assert list(got.items()) == list(jax_train.learn_bpe_sharded(batch, lengths, 14).items())
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []


def test_a_port_checkpoint_resumes_in_jax(tmp_path):
    batch, lengths = _rows(4)
    ckpt = str(tmp_path / "state.npz")
    train.learn_bpe_sharded(batch, lengths, 5, checkpoint_path=ckpt, checkpoint_every=2,
                            device=CPU)
    got = jax_train.learn_bpe_sharded(batch, lengths, 14, checkpoint_path=ckpt,
                                      checkpoint_every=2, resume=True)
    clean = train.learn_bpe_sharded(batch, lengths, 14, device=CPU)
    assert list(got.items()) == list(clean.items())
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []


def test_no_device_means_the_card(monkeypatch):
    """``device=None`` asks for the first CUDA device; without one it raises."""
    from blt_tpu_torch.utils import device as device_mod

    monkeypatch.setattr(device_mod, "cuda_device", lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.learn_bpe(b"abab", 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.learn_bpe_sharded(*_rows(1), 2)


# --- the CLI as a process ------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["BLT_PLATFORM"] = "cpu"
    return env


def _train(*args, module="blt_tpu_torch.train_cli"):
    extra = ["--device", "cpu"] if module == "blt_tpu_torch.train_cli" else []
    return subprocess.run([sys.executable, "-m", module, *map(str, args), *extra],
                          capture_output=True, env=_env(), timeout=300)


def test_train_cli_end_to_end(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"ababab cdcdcd " * 200)
    out = tmp_path / "merges.txt"
    r = _train(corpus, "-o", out, "-n", 4)
    assert r.returncode == 0, r.stderr.decode()
    assert len(load_bpe_merges_from_path(out)) >= 1


def test_train_cli_checkpoint_resume(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"hello world " * 300)
    out1, out2, ckpt = tmp_path / "m1.txt", tmp_path / "m2.txt", tmp_path / "state.npz"
    r = _train(corpus, "-o", out1, "-n", 2, "--rows", 2, "--checkpoint", ckpt,
               "--checkpoint-every", 1)
    assert r.returncode == 0, r.stderr.decode()
    assert ckpt.exists()
    r = _train(corpus, "-o", out1, "-n", 5, "--rows", 2, "--checkpoint", ckpt, "--resume")
    assert r.returncode == 0, r.stderr.decode()
    r = _train(corpus, "-o", out2, "-n", 5, "--rows", 2)
    assert r.returncode == 0, r.stderr.decode()
    assert out1.read_text() == out2.read_text()


def test_train_cli_empty_corpus_errors(tmp_path):
    corpus = tmp_path / "empty.bin"
    corpus.write_bytes(b"")
    r = _train(corpus, "-o", tmp_path / "m.txt")
    assert r.returncode == 1
    assert b"Error training merges" in r.stderr


@pytest.mark.parametrize("rows", [1, 3])
def test_train_cli_output_equals_jax(tmp_path, rows):
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(make_corpus(np.random.default_rng(rows), 20_000).tobytes())
    port, jax_out = tmp_path / "port.txt", tmp_path / "jax.txt"
    r = _train(corpus, "-o", port, "-n", 30, "--rows", rows)
    assert r.returncode == 0, r.stderr.decode()
    r = _train(corpus, "-o", jax_out, "-n", 30, "--rows", rows, module="blt_tpu.train_cli")
    assert r.returncode == 0, r.stderr.decode()
    assert port.read_bytes() == jax_out.read_bytes()


def test_train_cli_without_a_card_exits_1_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"abab " * 10)
    r = subprocess.run([sys.executable, "-m", "blt_tpu_torch.train_cli", str(corpus),
                        "-o", str(tmp_path / "m.txt")],
                       capture_output=True, env=_env(), timeout=300)
    assert r.returncode == 1
    assert b"Error training merges" in r.stderr and b"CUDA" in r.stderr
    assert not (tmp_path / "m.txt").exists()
