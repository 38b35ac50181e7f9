"""The one traffic generator: it reads a mix's parameters (a
``traffic/<name>.json`` file) and makes its input files from the seed.

Parameters:

- ``entry``: ``api`` (one ``ByteTokenizer`` a run, ``tokenize_file`` a job)
  or ``cli`` (``blt_tpu_torch.cli.main`` a job);
- ``content``: ``text`` (the Zipf text of ``recipes.text_corpus``) or
  ``bytes`` (uniform random bytes drawn on the device);
- ``content_type``: the header the job asks for (``text``, ``bin``, ...);
- ``files``: ``count``, ``min_bytes``, ``max_bytes``: the pool's sizes are
  the ``count`` log-spaced quantiles between the two, the same set for
  every seed; a text pool is consecutive slices of one corpus;
- ``order``: the pool cycled in one permutation drawn from the seed;
- ``warmup_bytes``: the warm-up job's input, the head of the first file.

Files live in anonymous memory (``memfd``), opened by the program through
``/dev/fd/<n>`` as any file path: a run writes nothing to disk, and the
program's read is from memory, as a file read from a warm page cache is.
"""

from __future__ import annotations

import itertools
import mmap
import os
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch

from h100_bench.common import recipes


@dataclass
class InputFile:
    fd: int
    data: np.ndarray  # the file's bytes, a view of its mapping

    @property
    def path(self) -> str:
        return f"/dev/fd/{self.fd}"

    @property
    def size(self) -> int:
        return int(self.data.shape[0])


def memory_file(name: str, size: int) -> InputFile:
    """An empty anonymous file of ``size`` bytes, mapped for writing."""
    fd = os.memfd_create(name)
    os.ftruncate(fd, size)
    if size == 0:
        return InputFile(fd, np.empty(0, np.uint8))
    return InputFile(fd, np.frombuffer(mmap.mmap(fd, size), dtype=np.uint8))


def memory_file_of(name: str, data) -> InputFile:
    f = memory_file(name, len(data))
    f.data[:] = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else data
    return f


def pool_sizes(files: dict) -> List[int]:
    """The ``count`` log-spaced quantiles of [``min_bytes``, ``max_bytes``]."""
    n, lo, hi = files["count"], files["min_bytes"], files["max_bytes"]
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)] if n > 1 else [lo]


class Inputs:
    """The input files of one run and the order of its jobs."""

    def __init__(self, traffic: dict, seed: int, device: torch.device):
        self.traffic = traffic
        sizes = pool_sizes(traffic["files"])
        total = sum(sizes)
        if traffic["content"] == "text":
            bulk = recipes.text_corpus(seed, total)
        elif traffic["content"] == "bytes":
            bulk = recipes.uniform_bytes(recipes.seed_of(seed, recipes.BYTES), total, device).cpu().numpy()
        else:
            raise ValueError(f"unknown content {traffic['content']!r}")
        self.files: List[InputFile] = []
        off = 0
        for i, size in enumerate(sizes):
            self.files.append(memory_file_of(f"h100_bench_input_{i}", bulk[off : off + size]))
            off += size
        del bulk
        self.permutation = np.random.default_rng(
            recipes.seed_of(seed, recipes.ORDER)).permutation(len(sizes))
        head = self.files[int(self.permutation[0])].data[: traffic["warmup_bytes"]]
        self.warmup = memory_file_of("h100_bench_warmup", head)

    def order(self) -> Iterator[int]:
        """File indices, job after job, for as long as the window asks."""
        return itertools.cycle(int(i) for i in self.permutation)

    def close(self) -> None:
        for f in self.files + [self.warmup]:
            os.close(f.fd)
