"""Input recipes, frozen here so that a change to the port cannot move the
yardstick.

``make_corpus`` and ``frequent_pairs`` are copies of
``blt_tpu_torch/tools/_common.py``'s (themselves copies of ``bench.py``'s);
``fifty_k_pairs`` is a copy of ``chip_smoke.py``'s. ``uniform_bytes`` draws
its bytes on the device from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

MIB = 1 << 20
# the named streams of a run's seed
TEXT, TABLE, BYTES, ORDER, TABLE_TEXT = 1, 2, 3, 4, 5


def seed_of(seed: int, stream: int) -> int:
    """A non-negative 63-bit seed for one named stream of a run's ``--seed``
    (any whole number, negative or past 64 bits included)."""
    return int(np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def make_corpus(rng: np.random.Generator, n: int) -> np.ndarray:
    """Zipf-ish text bytes: a 4 MiB base sample, tiled and rotated to ``n``."""
    alphabet = np.frombuffer(
        b"etaoinshrdlucmfwypvbgkjqxz ETAOIN,.;:'\"!?0123456789", np.uint8
    )
    weights = 1.0 / np.arange(1, len(alphabet) + 1)
    base_n = 4 * MIB
    base = rng.choice(alphabet, size=base_n, p=weights / weights.sum()).astype(np.uint8)
    reps = -(-n // base_n)
    shift = int(rng.integers(0, base_n))
    return np.roll(np.tile(base, reps)[:n], shift)


def text_corpus(seed: int, n: int) -> np.ndarray:
    """``n`` bytes of the run's text: ``make_corpus`` drawn from the seed,
    its 4 MiB base and its rotation both. Every seed draws the same
    alphabet under the same weights, and other text."""
    return make_corpus(np.random.default_rng(seed_of(seed, TEXT)), n)


def text_sample(seed: int) -> np.ndarray:
    """4 MiB of text of the same kind, drawn apart from the run's own text
    (a stream of its own of the seed): the table recipes learn from it, as
    a table is learned on one corpus and run on others."""
    return make_corpus(np.random.default_rng(seed_of(seed, TABLE_TEXT)), 4 * MIB)


def frequent_pairs(corpus: np.ndarray, k: int) -> list:
    """The k most frequent byte pairs of the corpus's first 4 MiB, most
    frequent first."""
    sample = corpus[: 4 * MIB]
    pairs, counts = np.unique(
        sample[:-1].astype(np.int32) * 256 + sample[1:].astype(np.int32),
        return_counts=True,
    )
    top = pairs[np.argsort(-counts, kind="stable")][:k]
    return [(int(p) // 256, int(p) % 256) for p in top]


def fifty_k_pairs(rng: np.random.Generator, first, total: int = 50_000) -> list:
    """``first`` then distinct random byte pairs, ``total`` in all."""
    pairs = list(first)
    seen = set(pairs)
    for code in rng.permutation(65536):
        if len(pairs) == total:
            break
        p = (int(code) // 256, int(code) % 256)
        if p not in seen:
            seen.add(p)
            pairs.append(p)
    return pairs


def numbered(pairs) -> dict:
    """Merges-file lines in order -> rules: line i makes token 256 + i."""
    return {p: 256 + i for i, p in enumerate(pairs)}


def merges_text(pairs) -> bytes:
    """The merges file of ``pairs``: one ``a b`` line each."""
    return "".join(f"{a} {b}\n" for a, b in pairs).encode()


def uniform_bytes(seed: int, n: int, device: torch.device) -> torch.Tensor:
    """``n`` uniform random bytes drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=device, generator=g)
