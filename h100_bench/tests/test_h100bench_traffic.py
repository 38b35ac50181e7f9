"""Each traffic mix's files from a seed, at a test's size; the sink."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from h100_bench import manifest
from h100_bench.common import recipes, traffic
from h100_bench.common.sink import Sink
from h100_bench.tests.conftest import MIB, small

CPU = torch.device("cpu")
SEEDS = [0, 7, 2**31 + 5, 3_000_000_000, -12]


def _files(inputs):
    return [bytes(f.data) for f in inputs.files]


@pytest.mark.parametrize("name", ["text.cli"])
def test_full_size_parameters(name):
    t = json.loads((manifest.HERE / "traffic" / f"{name}.json").read_text())
    sizes = traffic.pool_sizes(t["files"])
    assert sum(sizes) <= 1 << 30 and min(sizes) >= 1
    assert t["entry"] in ("api", "cli") and t["content"] in ("text", "bytes")
    assert t["content_type"] in ("text", "bin") and t["warmup_bytes"] <= max(sizes)


# a pool of files and a mix of random bytes, which the generator reads from
# a mix's file as well as the cells' one text file
POOL = {"entry": "api", "content": "text", "content_type": "text",
        "files": {"count": 6, "min_bytes": MIB // 4, "max_bytes": 2 * MIB}, "warmup_bytes": MIB // 4}
BYTES = dict(POOL, content="bytes", content_type="bin",
             files={"count": 1, "min_bytes": MIB, "max_bytes": MIB})


@pytest.mark.parametrize("which", ["flat50k.text", "pool", "bytes"])
def test_inputs_from_the_seed(which, cells):
    mix = {"pool": POOL, "bytes": BYTES}.get(which) or small(cells[which], file_bytes=MIB).traffic
    runs = {}
    for seed in SEEDS + [7]:
        inputs = traffic.Inputs(mix, seed, CPU)
        try:
            order = inputs.order()
            runs.setdefault(seed, []).append(
                (_files(inputs), [next(order) for _ in range(2 * len(inputs.files))],
                 bytes(inputs.warmup.data)))
            for f in inputs.files:
                with open(f.path, "rb") as fh:  # a path the program can open
                    assert fh.read() == bytes(f.data)
        finally:
            inputs.close()
    a, b = runs[7]
    assert a == b  # the same seed gives the same inputs
    sizes = {tuple(len(x) for x in r[0][0]) for r in runs.values()}
    assert len(sizes) == 1  # every seed the same sizes
    assert len({r[0][0][0] for r in runs.values()}) == len(SEEDS)  # and other bytes or order
    files, order, warm = a
    assert sorted(set(order)) == list(range(len(files)))
    assert warm == files[order[0]][: len(warm)]


def test_pool_sizes_are_log_spaced_quantiles():
    sizes = traffic.pool_sizes({"count": 64, "min_bytes": MIB, "max_bytes": 64 * MIB})
    assert len(sizes) == 64 and sizes == sorted(sizes)
    assert MIB <= sizes[0] < sizes[-1] <= 64 * MIB
    assert abs(sum(sizes) / MIB - 969.3) < 0.1
    assert traffic.pool_sizes({"count": 1, "min_bytes": 5, "max_bytes": 5}) == [5]


def test_text_is_drawn_from_the_seed():
    """Each seed draws its own 4 MiB base, tiled and rotated, of the same
    alphabet under the same weights; the tables learn from text drawn apart
    from it."""
    a, b = recipes.text_corpus(1, 8 * MIB), recipes.text_corpus(2, 8 * MIB)
    assert np.array_equal(a[: 4 * MIB], a[4 * MIB :])  # the base, tiled
    ca, cb = np.bincount(a[: 4 * MIB], minlength=256), np.bincount(b[: 4 * MIB], minlength=256)
    assert (ca != cb).any()  # another base, not the same one rotated
    assert np.abs(ca - cb).max() / (4 * MIB) < 0.002  # of the same kind
    assert np.array_equal(recipes.text_corpus(1, 4 * MIB), a[: 4 * MIB])
    sample = recipes.text_sample(1)
    assert sample.shape == (4 * MIB,) and (np.bincount(sample, minlength=256) != ca).any()
    assert recipes.seed_of(-1, 1) != recipes.seed_of(1, 1) and recipes.seed_of(2**70, 1) >= 0


def test_sink_keeps_then_compares():
    sink = Sink()
    try:
        for payload, same in [(b"abcdef" * 1000, None), (b"abcdef" * 1000, True),
                              (b"abcdeg" * 1000, False), (b"abcdef" * 999, False),
                              (b"abcdef" * 1001, False)]:
            path = sink.start(3, 10_000)
            with open(path, "wb") as f:
                f.write(payload)
            out = sink.finish()
            assert (out.nbytes, out.same, out.overflow) == (len(payload), same, False)
        assert bytes(sink.kept[3]) == b"abcdef" * 1000
        sink.prepare(5, 1 << 22)  # a large stream, read in many pieces
        big = np.random.default_rng(0).integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
        for same in (None, True):
            path = sink.start(5, 1 << 22)
            with open(path, "wb") as f:
                f.write(big)
            assert sink.finish().same is same
        path = sink.start(4, 10)
        with open(path, "wb") as f:
            f.write(b"x" * 100)
        assert sink.finish().overflow
        sink.forget(4)
        assert 4 not in sink.kept
    finally:
        sink.close()
    assert sink._proc.returncode == 0  # the reader process has ended
    assert bytes(sink.kept[5]) == big  # and what it kept stays readable


def test_sink_survives_a_job_that_never_opens_it():
    sink = Sink()
    try:
        sink.start(0, 16)
        out = sink.finish()
        assert out.nbytes == 0 and bytes(sink.kept[0]) == b""
        assert os.path.exists("/dev/fd/0")
    finally:
        sink.close()
