"""The plain reference against hand-worked cases (``blt``'s pinned examples)
and against the literal oracle; the judge; the control; the recipes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100_bench.common import recipes
from h100_bench.reference import bpe, judge, oracle
from h100_bench.reference.control import KEPT_RULES, Control
from h100_bench.tables import frequent_then_random

CPU = torch.device("cpu")


def ref(data: bytes, rules, chunk=None):
    arr = np.frombuffer(data, np.uint8)
    return bpe.Reference(rules, chunk, CPU).encode_host(arr).tolist()


@pytest.mark.parametrize("data, rules, want", [
    # blt's tokenizer tests: passes repeat, a merged token merges next pass
    (b"abcde", {(97, 98): 256, (256, 99): 257}, [257, 100, 101]),
    # a value may collide with a byte value
    (b"axyza", {(120, 121): 90}, [97, 90, 122, 97]),
    # leftmost, non-overlapping, no rank order
    (b"aaa", {(97, 97): 256}, [256, 97]),
    (b"aaaa", {(97, 97): 256}, [256, 256]),
    (b"abc", {(98, 99): 257, (97, 98): 256}, [256, 99]),
    # no rule: the bytes themselves
    (b"abc", {(1, 2): 256}, [97, 98, 99]),
    (b"", {(97, 98): 256}, []),
    (b"a", {(97, 98): 256}, [97]),
])
def test_pinned_examples(data, rules, want):
    assert ref(data, rules, chunk=64) == want
    assert oracle.encode(list(data), rules, 64) == want


def test_flatness():
    assert bpe.is_flat({(97, 98): 256, (99, 100): 257})
    assert not bpe.is_flat({(97, 98): 256, (256, 99): 257})
    assert not bpe.is_flat({(120, 121): 90, (90, 97): 300})  # a value that is a key member
    assert not bpe.is_flat({(300, 1): 400})


def _random_rules(rng, n, hierarchical_keys):
    rules = {}
    alphabet = list(range(97, 101))
    for i in range(n):
        pool = alphabet + ([256 + j for j in range(i)] if hierarchical_keys else [])
        rules[(int(rng.choice(pool)), int(rng.choice(pool)))] = 256 + i
    return {k: v for k, v in rules.items()}


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("hier", [False, True])
def test_against_oracle(seed, hier):
    rng = np.random.default_rng(seed)
    rules = _random_rules(rng, 12, hier)
    data = rng.integers(97, 101, size=int(rng.integers(1, 3000)), dtype=np.uint8)
    chunk = int(rng.integers(7, 900))
    flat = bpe.is_flat(rules)
    want = oracle.encode(list(data), rules, len(data) if flat else chunk)
    assert bpe.Reference(rules, chunk, CPU).encode_host(data).tolist() == want


@pytest.mark.parametrize("block", [1, 2, 3, 5, 64, 4096])
def test_flat_pass_carries_across_blocks(block):
    rng = np.random.default_rng(block)
    rules = {(97, 97): 256, (97, 98): 257, (98, 97): 258}
    data = rng.integers(97, 99, size=1001, dtype=np.uint8)
    dense = bpe.dense_table(rules, CPU)
    got = torch.cat(list(bpe.flat_pass(data, dense, block=block))).tolist()
    assert got == oracle.encode(list(data), rules, len(data))


def test_chunked_multipass_groups_chunks():
    rng = np.random.default_rng(3)
    rules = {(97, 98): 256, (256, 97): 257, (257, 98): 258}
    data = rng.integers(97, 99, size=5000, dtype=np.uint8)
    keys, vals = bpe.rule_tensors(rules, CPU)
    for group in (100, 700, 10_000):
        got = torch.cat(list(bpe.chunked_multipass(data, keys, vals, 100, group=group))).tolist()
        assert got == oracle.encode(list(data), rules, 100)


def _stream(tokens, header):
    toks = ([header] if header is not None else []) + list(tokens)
    return np.array(toks, dtype=">u2").view(np.uint8)


def test_judge_counts():
    blocks = [torch.tensor([1, 2, 3], dtype=torch.int32), torch.tensor([300, 4], dtype=torch.int32)]
    good = _stream([1, 2, 3, 300, 4], 0xFF01)
    assert judge.wrong_tokens(good, 0xFF01, blocks, CPU) == (0, None)
    altered = good.copy()
    altered[9] ^= 1  # the fifth token, 300 -> 301
    assert judge.wrong_tokens(altered, 0xFF01, blocks, CPU) == (1, 4)
    assert judge.wrong_tokens(good[:-4], 0xFF01, blocks, CPU) == (2, 4)
    assert judge.wrong_tokens(np.concatenate([good, good[:3]]), 0xFF01, blocks, CPU) == (2, 6)
    assert judge.wrong_tokens(good[2:], None, blocks, CPU) == (0, None)
    assert judge.wrong_tokens(good, None, blocks, CPU)[0] > 0  # a header that should not be there
    assert judge.LIMITS == {"jobs_wrong": 0, "tokens_wrong": 0}


def test_control_breaks_the_table():
    text = recipes.text_corpus(5, 1 << 20)
    flat = frequent_then_random.build({"frequent": 500, "rules": 50000}, 5, CPU)
    assert len(flat.rules) == 50000 > KEPT_RULES
    want = bpe.Reference(flat.rules, None, CPU).encode_host(text)
    got = torch.cat(list(Control(flat.rules, None, CPU).encode(text))).numpy()
    assert got.shape != want.shape or (got != want).any()
    with pytest.raises(ValueError):
        Control({(97, 98): 256, (256, 99): 257}, None, CPU)


def test_recipes_are_frozen_copies():
    """The copies give what the repo's originals gave: the alphabet's Zipf
    text, the 500-pair head of the 50k table and its 50,000 distinct pairs."""
    base = recipes.text_sample(9)
    assert base.shape == (4 << 20,) and set(np.unique(base)) <= set(
        b"etaoinshrdlucmfwypvbgkjqxz ETAOIN,.;:'\"!?0123456789")
    table = frequent_then_random.build({"frequent": 500, "rules": 50000}, 9, CPU)
    assert table.pairs[:500] == recipes.frequent_pairs(base, 500)
    assert len(set(table.pairs)) == 50000 and bpe.is_flat(table.rules)
    assert recipes.merges_text(table.pairs[:2]) == f"{table.pairs[0][0]} {table.pairs[0][1]}\n{table.pairs[1][0]} {table.pairs[1][1]}\n".encode()
