"""Public Python API of the torch port: ``ByteTokenizer`` (port of
``blt_tpu/api.py``).

Same constructor validation and methods as the JAX package's tokenizer;
``engine`` is ``"torch"`` (the default: the CUDA kernels, which need a CUDA
device), ``"shard"`` (the kernels on every CUDA device), ``"numpy"`` (the
host engine) or ``"auto"``. ``tokenize_file``
runs the port's runner; ``tokenize_bytes``, ``detokenize_bytes`` and
``detokenize_file`` are host code (decode is host-only by design).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from blt_tpu_torch.config import ContentType, CoreConfig, Engine
from blt_tpu_torch.merges import MergeTable
from blt_tpu_torch.pipeline.engines import ENGINES
from blt_tpu_torch.pipeline.runner import run_tokenizer
from blt_tpu_torch.utils.logging import get_logger
from blt_tpu_torch.utils.profiling import job

log = get_logger("api")


class ByteTokenizer:
    """High-level byte-level tokenizer on the torch engine."""

    def __init__(
        self,
        merges: Optional[Mapping[Tuple[int, int], int]] = None,
        content_type: Optional[str] = None,
        threads: Optional[int] = None,
        chunk_size: Optional[str] = None,
        memory_cap: Optional[int] = None,
        engine: str = "torch",
    ):
        if memory_cap is not None and not (0 <= memory_cap <= 100):
            raise ValueError("memory_cap must be between 0 and 100")
        if content_type is not None and content_type not in ("Text", "Bin"):
            raise ValueError("content_type must be 'Text' or 'Bin'")
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.merges: Optional[Dict[Tuple[int, int], int]] = (
            {(int(a), int(b)): int(v) for (a, b), v in merges.items()}
            if merges is not None
            else None
        )
        self.content_type = content_type
        self.threads = threads
        self.chunk_size = chunk_size
        self.memory_cap = memory_cap
        self.engine = engine
        self._exp_table = None  # decode expansions, built lazily once
        self._merge_table = None  # encode table, built lazily once

    def _config(self, input_path: str, output_path: str) -> CoreConfig:
        ct = ContentType(self.content_type) if self.content_type else None
        config = CoreConfig.new_from_cli(
            input=Path(input_path),
            output=Path(output_path),
            merges=None,
            content_type=ct,
            threads=self.threads,
            chunksize=self.chunk_size,
            memcap=self.memory_cap,
            passthrough=False,  # the Python API never uses passthrough
            engine=Engine(self.engine),
        )
        if self.merges is not None:
            config.with_merges(self.merges)
        return config

    def tokenize_file(self, input_path: str, output_path: str) -> None:
        """Tokenize input_path into output_path (u16-BE token stream)."""
        with job(log, self.engine):
            run_tokenizer(self._config(input_path, output_path))

    def detokenize_file(self, input_path: str, output_path: str) -> None:
        """Invert a token stream this tokenizer produced (host decode)."""
        config = self._config(input_path, output_path)
        config.decode_mode = True
        run_tokenizer(config)

    def detokenize_bytes(self, data: bytes) -> bytes:
        """In-memory inverse of the wire form: u16-BE -> bytes."""
        from blt_tpu_torch.ops.decode import (
            build_expansion_table,
            decode_wire,
            odd_trailing_error,
        )

        if len(data) % 2:
            raise odd_trailing_error()
        if self._exp_table is None:
            self._exp_table = build_expansion_table(self.merges)
        return decode_wire(np.frombuffer(data, np.uint8), self._exp_table).tobytes()

    def tokenize_bytes(self, data: bytes) -> np.ndarray:
        """In-memory tokenization: bytes -> int32 token ids (host code)."""
        from blt_tpu_torch.ops import bpe_numpy

        arr = np.frombuffer(data, dtype=np.uint8)
        if self.merges is None:
            return arr.astype(np.int32)
        if self._merge_table is None:
            self._merge_table = MergeTable.build(self.merges)
        return bpe_numpy.bpe_encode(arr, self._merge_table)

    def __repr__(self) -> str:
        n_merges = len(self.merges) if self.merges is not None else 0
        return (
            f"ByteTokenizer(merges={n_merges}, content_type={self.content_type!r}, "
            f"threads={self.threads!r}, chunk_size={self.chunk_size!r}, "
            f"memory_cap={self.memory_cap!r}, engine={self.engine!r})"
        )
