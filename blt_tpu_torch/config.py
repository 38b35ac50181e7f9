"""Central configuration and mode selection (copy of ``blt_tpu/config.py``;
``Engine`` has the port's members).

Reference: blt_core/src/lib.rs:111-130 ``CoreConfig``, lib.rs:149-174
``new_from_cli``, lib.rs:271-282 ``select_strategy``, lib.rs:82-104
``ContentType`` with reserved tokens 0xFF01-0xFF04.

Mode-selection truth table (lib.rs:271-282):
    passthrough flag set        -> passthrough
    else merges table present   -> BPE
    else                        -> basic byte->u16
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from blt_tpu_torch import merges as merges_mod
from blt_tpu_torch.merges import BpeMerges, MergeTable
from blt_tpu_torch.utils.parsing import (
    SizeParseError,
    determine_thread_count,
    parse_chunk_size_str,
)


class ContentType(enum.Enum):
    """Content-type header tokens, reserved range 0xFF01-0xFF04 (lib.rs:96-103)."""

    TEXT = "Text"
    AUDIO = "Audio"
    BIN = "Bin"
    VIDEO = "Video"

    @property
    def token_value(self) -> int:
        return {
            ContentType.TEXT: 0xFF01,
            ContentType.AUDIO: 0xFF02,
            ContentType.BIN: 0xFF03,
            ContentType.VIDEO: 0xFF04,
        }[self]

    @staticmethod
    def from_cli(name: str) -> "ContentType":
        return {
            "text": ContentType.TEXT,
            "audio": ContentType.AUDIO,
            "bin": ContentType.BIN,
            "video": ContentType.VIDEO,
        }[name.lower()]


class Mode(enum.Enum):
    BASIC = "basic"
    BPE = "bpe"
    PASSTHROUGH = "passthrough"
    # Inverse direction: u16-BE token stream -> original bytes. No reference
    # analog (the reference cannot invert its own output); see ops/decode.py.
    DECODE = "decode"


class Engine(enum.Enum):
    """Compute backend for the tokenization kernels.

    TORCH (the default) runs the CUDA kernels on the first CUDA device and
    fails without one; SHARD runs them on every CUDA device, a batch's rows
    over the devices (``ShardedTorchEngine``), and fails without one; NUMPY
    is the host engine, the way to ask for the CPU; AUTO picks the device
    engine for large inputs when a CUDA device exists (SHARD's on a host of
    several), else the host engine (the JAX package's size rule).
    """

    AUTO = "auto"
    TORCH = "torch"
    NUMPY = "numpy"
    SHARD = "shard"


@dataclass
class CoreConfig:
    """All operational parameters for one tokenizer run (lib.rs:111-130)."""

    input: Optional[Path] = None  # None -> stdin
    output: Optional[Path] = None  # None -> stdout
    merges_file: Optional[Path] = None
    content_type: Optional[ContentType] = None
    num_threads: int = 1
    cli_chunk_size: Optional[int] = None
    mem_cap_percent: int = 80
    bpe_data: Optional[BpeMerges] = None
    passthrough_mode: bool = False
    decode_mode: bool = False
    engine: Engine = Engine.TORCH
    merge_table: Optional[MergeTable] = field(default=None, repr=False)

    @staticmethod
    def new_from_cli(
        input: Optional[Path] = None,
        output: Optional[Path] = None,
        merges: Optional[Path] = None,
        content_type: Optional[ContentType] = None,
        threads: Optional[int] = None,
        chunksize: Optional[str] = None,
        memcap: Optional[int] = None,
        passthrough: bool = False,
        decode: bool = False,
        engine: Engine = Engine.TORCH,
    ) -> "CoreConfig":
        """Primary constructor: parse, validate, eagerly load merges.

        Mirrors lib.rs:149-174: thread autodetect, chunk-size parse (errors
        surface as OSError/InvalidInput analog), eager merges load at startup
        (the replicate-once analog of Arc<BpeMerges>).
        """
        num_threads = determine_thread_count(threads)
        cli_chunk_size: Optional[int] = None
        if chunksize is not None:
            try:
                cli_chunk_size = parse_chunk_size_str(chunksize)
            except SizeParseError as e:
                raise OSError(str(e)) from None

        bpe_data: Optional[BpeMerges] = None
        merge_table: Optional[MergeTable] = None
        if merges is not None:
            try:
                bpe_data = merges_mod.load_bpe_merges_from_path(merges)
            except merges_mod.MergesFormatError as e:
                raise OSError(f"Failed to load BPE merges: {e}") from None
            except FileNotFoundError as e:
                raise OSError(f"Failed to load BPE merges: {e}") from None
            merge_table = MergeTable.build(bpe_data)

        return CoreConfig(
            input=Path(input) if input is not None else None,
            output=Path(output) if output is not None else None,
            merges_file=Path(merges) if merges is not None else None,
            content_type=content_type,
            num_threads=num_threads,
            cli_chunk_size=cli_chunk_size,
            mem_cap_percent=memcap if memcap is not None else 80,
            bpe_data=bpe_data,
            passthrough_mode=passthrough,
            decode_mode=decode,
            engine=engine,
            merge_table=merge_table,
        )

    def with_merges(self, table: BpeMerges) -> "CoreConfig":
        """Attach an in-memory merges map (the Arc<BpeMerges> API analog).

        Unlike the reference Python binding — which round-trips only the dict
        KEYS through a temp file, silently discarding user token values
        (blt_python/src/lib.rs:111-113) — values are honored directly. This is
        a documented behavior fix (SURVEY.md 2.1.9).
        """
        self.bpe_data = dict(table)
        self.merge_table = MergeTable.build(self.bpe_data)
        return self

    @property
    def mode(self) -> Mode:
        """Strategy selection truth table (lib.rs:271-282).

        Passthrough keeps winning over everything (reference precedence);
        decode inverts whichever encoding the other flags describe (merges
        present -> BPE decode, else basic decode).
        """
        if self.passthrough_mode:
            return Mode.PASSTHROUGH
        if self.decode_mode:
            return Mode.DECODE
        if self.bpe_data is not None:
            return Mode.BPE
        return Mode.BASIC

    def table(self) -> MergeTable:
        if self.merge_table is None:
            self.merge_table = MergeTable.build(self.bpe_data or {})
        return self.merge_table
