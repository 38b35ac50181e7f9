"""Input sources and output sinks (copy of ``blt_tpu/io/sources.py``).

Reference: blt_core/src/io_handler.rs — ``InputSource::{Mmap, Stdin}``
(io_handler.rs:32-37), mmap'd file input (io_handler.rs:54-56), buffered
file/stdout output (io_handler.rs:68-76). stdin/stdout are used when the
corresponding path is omitted (io_handler.rs:52-75). Additionally the
documented-but-unimplemented ``-`` convention (reference README.md:102-103;
no code path in the reference handles it, SURVEY.md 2.1.8) is honored here:
``-`` means stdin/stdout explicitly.

File input is zero-copy via ``np.memmap``; chunk slices view the page cache
directly, the engines read straight out of the mapping.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np


def _is_stdio(path: Optional[Path]) -> bool:
    return path is None or str(path) == "-"


class InputSource:
    """Either a memory-mapped file (known size) or a byte stream (stdin)."""

    def __init__(self, path: Optional[Path]):
        self.path = path
        if _is_stdio(path):
            self.mmap: Optional[np.ndarray] = None
            self.stream: Optional[BinaryIO] = sys.stdin.buffer
            self.size: Optional[int] = None
        else:
            size = os.path.getsize(path)
            if size == 0:
                # np.memmap rejects empty files; an empty array is equivalent.
                self.mmap = np.empty(0, dtype=np.uint8)
            else:
                self.mmap = np.memmap(path, dtype=np.uint8, mode="r")
            self.stream = None
            self.size = size

    @property
    def is_mmap(self) -> bool:
        return self.mmap is not None

    def chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        """Yield uint8 chunk views (mmap) or fresh buffers (stream) in order.

        Stream chunks may be short reads before EOF, exactly like the
        reference's single-read semantics (pipeline.rs:311); harmless for all
        modes here because the flat BPE path carries exact boundary state.
        """
        if self.is_mmap:
            n = self.mmap.shape[0]
            for start in range(0, n, chunk_size):
                yield self.mmap[start : min(start + chunk_size, n)]
        else:
            readinto = getattr(self.stream, "readinto", None)
            while True:
                buf = bytearray(chunk_size)
                if readinto is not None:
                    got = readinto(buf)
                    if not got:
                        return
                    yield np.frombuffer(memoryview(buf)[:got], dtype=np.uint8)
                else:
                    data = self.stream.read(chunk_size)
                    if not data:
                        return
                    yield np.frombuffer(data, dtype=np.uint8)


class OutputWriter:
    """Buffered binary writer over a file path or stdout."""

    def __init__(self, path: Optional[Path]):
        self.path = path
        if _is_stdio(path):
            self._f: BinaryIO = sys.stdout.buffer
            self._own = False
        else:
            self._f = open(path, "wb", buffering=1024 * 1024)
            self._own = True

    def write(self, data) -> None:
        self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if getattr(self, "_closed", False):
            return
        self._closed = True
        try:
            self.flush()
        finally:
            # the fd must not leak even when the flush raises (ENOSPC)
            if self._own:
                self._f.close()

    def __enter__(self) -> "OutputWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def setup_io(input_path: Optional[Path], output_path: Optional[Path]) -> Tuple[InputSource, OutputWriter]:
    """io_handler::setup_io analog (io_handler.rs:51-66)."""
    return InputSource(input_path), OutputWriter(output_path)


def kernel_copy(src: InputSource, writer: OutputWriter) -> bool:
    """Zero-copy file->file passthrough via copy_file_range/sendfile.

    The reference's passthrough benches mmap + copy + buffered write
    (tokenizer.rs:136-145 over pipeline.rs); for a pure identity map the
    bytes never need to enter user space at all — the kernel moves pages
    directly between the two file descriptions (reflink on supporting
    filesystems, page-cache copy otherwise). Returns False when the pair
    is not two regular files (stdin/stdout, sockets) or the syscall is
    unavailable; the caller falls back to the engine stream.
    """
    if not src.is_mmap or src.path is None:
        return False
    if writer.path is None or str(writer.path) == "-" or not writer._own:
        return False
    copy_range = getattr(os, "copy_file_range", None)
    sendfile = getattr(os, "sendfile", None)
    if copy_range is None and sendfile is None:
        return False
    # Any already-buffered prefix (the content-type header) must land
    # before the raw-fd copy.
    writer.flush()
    out_fd = writer._f.fileno()
    remaining = src.size or 0
    offset = 0
    with open(src.path, "rb") as f:
        in_fd = f.fileno()
        while remaining > 0:
            try:
                if copy_range is not None:
                    sent = copy_range(in_fd, out_fd, remaining, offset_src=offset)
                else:
                    sent = sendfile(out_fd, in_fd, offset, remaining)
            except OSError:
                # cross-filesystem / unsupported pairing: fall back cleanly
                # only if nothing was moved yet, else resume with bounded
                # reads (pread caps a single call at ~2 GiB and may return
                # short — a single full-remainder read would truncate).
                if offset == 0:
                    return False
                while remaining > 0:
                    data = os.pread(in_fd, min(remaining, 64 << 20), offset)
                    if not data:
                        break
                    writer.write(data)
                    offset += len(data)
                    remaining -= len(data)
                break
            if sent == 0:
                break
            offset += sent
            remaining -= sent
    if remaining > 0:
        # the source shrank mid-copy (concurrent truncation): failing
        # loudly beats logging success over a silently short output —
        # the runner's partial-output cleanup then removes the file
        raise OSError(
            f"input truncated during passthrough copy: {remaining} of "
            f"{src.size} bytes missing"
        )
    return True
