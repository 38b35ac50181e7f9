"""BPE merges-table loading and representation (copy of
``blt_tpu/merges.py``, without the flat-kernel lookup layouts: CHD,
cuckoo16 and packed-dense are Mosaic layouts that the card does not use).

File grammar reproduced exactly from the reference loader
(reference: blt_core/src/config_loader.rs:14-46, pinned by its tests at
config_loader.rs:50-203):

- lines starting with ``#`` and *empty* lines are skipped (a whitespace-only
  line is NOT empty and is a format error);
- every other line must contain exactly two whitespace-separated u8 values
  (0-255; values >255 or non-numeric are errors with distinguishable
  "first"/"second" messages);
- new token ids are assigned 256, 257, ... **per valid line**, even when the
  pair duplicates an earlier line (last line wins the pair, the earlier id is
  orphaned) — pinned by config_loader.rs:167-202.

The in-memory representation is ``MergeTable``: a dict with exactly the
reference's ``BpeMerges = HashMap<(u16,u16),u16>`` shape (lib.rs:75), plus
device-ready dense/sparse lookup arrays. Because file-loaded tables always
have keys < 256 and values >= 256, they satisfy the *flat* property (merged
tokens can never re-merge), which the TPU kernels exploit; the general
multi-pass path covers arbitrary in-memory tables (e.g. hierarchical rules
like (256,99)->257 used by tokenizer.rs:204-212 tests).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

import numpy as np

BpeMerges = Dict[Tuple[int, int], int]

# Sentinel in dense lookup tables meaning "no rule for this pair". Must be
# outside u16 range so it can never collide with a real merge value.
NO_RULE = -1


class MergesFormatError(ValueError):
    """Malformed merges file (reference: io::ErrorKind::InvalidData)."""


def parse_merges_text(text: str) -> BpeMerges:
    """Parse merges-file text into the (u16,u16)->u16 map.

    Exact semantics of config_loader.rs:14-46 including id accounting.
    """
    merges: BpeMerges = {}
    vocab_size = 256
    for line in text.splitlines():
        if line.startswith("#") or line == "":
            continue
        parts = line.split()
        if len(parts) != 2:
            raise MergesFormatError(
                f"Invalid merge rule format in line: '{line}'. "
                "Expected two numbers separated by space."
            )
        byte1 = _parse_u8(parts[0], "first", line)
        byte2 = _parse_u8(parts[1], "second", line)
        merges[(byte1, byte2)] = vocab_size
        vocab_size += 1
    return merges


def _parse_u8(token: str, which: str, line: str) -> int:
    try:
        # Rust's u8::parse accepts an optional leading '+' and digits only.
        t = token[1:] if token.startswith("+") else token
        if not (t and all(c.isdigit() and c.isascii() for c in t)):
            raise ValueError("invalid digit found in string")
        value = int(t)
        if value > 255:
            raise ValueError("number too large to fit in target type")
        return value
    except ValueError as e:
        raise MergesFormatError(
            f"Failed to parse {which} byte value: {e} in line '{line}'"
        ) from None


def load_bpe_merges_from_path(path: str | os.PathLike) -> BpeMerges:
    """Load merges from a file path (config_loader.rs:14 entry point)."""
    with io.open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_merges_text(f.read())


def load_bpe_merges(path: str | os.PathLike) -> Dict[Tuple[int, int], int]:
    """Public u8-pair loader mirroring ``blt.load_bpe_merges``.

    Reference: blt_core/src/lib.rs:216-230 filters pairs to u8 range for the
    Python API; file-loaded pairs are always u8 so this is the identity here.
    """
    merges = load_bpe_merges_from_path(path)
    return {(a, b): t for (a, b), t in merges.items() if a <= 255 and b <= 255}


@dataclass
class MergeTable:
    """Device-ready merge table.

    ``flat`` means no rule *value* ever appears as a member of any rule *key*,
    so a merged token can never participate in a later merge. In that case the
    whole multi-pass reference algorithm (tokenizer.rs:63-86) provably
    terminates after one merging pass, and the TPU kernel runs a single
    parity-scan pass over raw bytes — exactly bit-equal to the reference run
    with chunk size >= input. File-loaded tables (keys < 256, values >= 256)
    are always flat.
    """

    merges: BpeMerges
    # Dense [256*256] int32 lookup for byte-pair keys: value or NO_RULE.
    dense: np.ndarray = field(repr=False)
    # True if the single-pass flat kernel is exact for this table.
    flat: bool = False
    # Sparse u32-key table for general (u16,u16) keys, sorted for searchsorted.
    sparse_keys: np.ndarray = field(repr=False, default=None)
    sparse_vals: np.ndarray = field(repr=False, default=None)

    @staticmethod
    def build(merges: Mapping[Tuple[int, int], int]) -> "MergeTable":
        merges = dict(merges)
        for (a, b), v in merges.items():
            # the reference's BpeMerges is HashMap<(u16,u16),u16> (lib.rs:75);
            # Python ints need the range check the Rust types gave for free
            if not (0 <= a <= 0xFFFF and 0 <= b <= 0xFFFF and 0 <= v <= 0xFFFF):
                raise ValueError(
                    f"merge rule ({a},{b})->{v} outside the u16 token range"
                )
        dense = np.full(256 * 256, NO_RULE, dtype=np.int32)
        key_members = set()
        for (a, b), v in merges.items():
            key_members.add(a)
            key_members.add(b)
            if a < 256 and b < 256:
                dense[a * 256 + b] = v
        values = set(merges.values())
        all_keys_byte = all(a < 256 and b < 256 for a, b in merges)
        flat = all_keys_byte and not (values & key_members)

        keys = np.array(
            sorted((a << 16) | b for a, b in merges), dtype=np.uint32
        )
        lut = {(a << 16) | b: v for (a, b), v in merges.items()}
        vals = np.array([lut[int(k)] for k in keys], dtype=np.int32)
        return MergeTable(
            merges=merges,
            dense=dense,
            flat=flat,
            sparse_keys=keys,
            sparse_vals=vals,
        )

    def __len__(self) -> int:
        return len(self.merges)

    def cuckoo_slots(self, min_slots: int = 256, max_slots: int = 8192) -> int:
        """Smallest power-of-two slot count with cuckoo headroom (~0.65/2)."""
        n = max(len(self.merges), 1)
        slots = min_slots
        while slots < max_slots and n > int(slots * 1.3):
            slots *= 2
        return slots

    def build_cuckoo32(self, slots: int | None = None, max_seed_tries: int = 64):
        """Memoizing wrapper over the cuckoo placement below.

        Default-argument builds are cached on the table: every encoder's
        supports()+__init__ pair would otherwise re-run the placement (up
        to 64 seed tries) two or three times per stream.
        """
        default_call = slots is None and max_seed_tries == 64
        if default_call:
            if "_cuckoo32_memo" not in self.__dict__:
                self.__dict__["_cuckoo32_memo"] = self._build_cuckoo32_impl()
            return self.__dict__["_cuckoo32_memo"]
        return self._build_cuckoo32_impl(slots, max_seed_tries)

    def _build_cuckoo32_impl(
        self, slots: int | None = None, max_seed_tries: int = 64
    ):
        """2-table cuckoo over 32-bit pair keys for the multipass token
        kernel (general tables: keys may be any (u16,u16), e.g. hierarchical
        rules like (256,99)->257).

        Key = ``(a << 16) | b`` wrapped to int32, matching the device's
        ``a * 65536 + b`` int32 arithmetic exactly. Keys and values live in
        separate int32 planes so no packing limits the key range; empty
        slots carry value -1, which no real rule can have (values are u16),
        so a hit is ``key_plane == p AND value_plane >= 0``.

        Returns (K1, V1, K2, V2, A1, A2) or None when placement fails.
        """
        if slots is None:
            slots = self.cuckoo_slots()

        def wrap32(x: int) -> int:
            x &= 0xFFFFFFFF
            return x - (1 << 32) if x >= 1 << 31 else x

        rules = [
            (wrap32((a << 16) | b), v) for (a, b), v in self.merges.items()
        ]
        if len(rules) > slots:  # 2-way cuckoo load limit ~0.5 of 2*slots
            return None
        rng = np.random.default_rng(0x32B17)
        mask = slots - 1
        shift = 32 - (slots.bit_length() - 1)
        for _ in range(max_seed_tries):
            a1 = int(rng.integers(1, 2**31)) | 1
            a2 = int(rng.integers(1, 2**31)) | 1

            def _hash(p: int, a: int) -> int:
                return (wrap32(p * a) >> shift) & mask

            t1: dict = {}
            t2: dict = {}
            ok = True
            for key, val in rules:
                k, v, which = key, val, 0
                for _kick in range(256):
                    if which == 0:
                        slot = _hash(k, a1)
                        if slot not in t1:
                            t1[slot] = (k, v)
                            break
                        k2, v2 = t1[slot]
                        t1[slot] = (k, v)
                        k, v, which = k2, v2, 1
                    else:
                        slot = _hash(k, a2)
                        if slot not in t2:
                            t2[slot] = (k, v)
                            break
                        k2, v2 = t2[slot]
                        t2[slot] = (k, v)
                        k, v, which = k2, v2, 0
                else:
                    ok = False
                    break
            if ok:
                k1 = np.zeros(slots, dtype=np.int32)
                v1 = np.full(slots, -1, dtype=np.int32)
                k2_ = np.zeros(slots, dtype=np.int32)
                v2_ = np.full(slots, -1, dtype=np.int32)
                for slot, (k, v) in t1.items():
                    k1[slot] = k
                    v1[slot] = v
                for slot, (k, v) in t2.items():
                    k2_[slot] = k
                    v2_[slot] = v
                return k1, v1, k2_, v2_, a1, a2
        return None
