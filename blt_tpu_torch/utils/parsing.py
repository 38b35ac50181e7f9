"""CLI-compatible size-string and thread-count parsing (copy of
``blt_tpu/utils/parsing.py``).

Reproduces the exact grammar of the reference's utils
(reference: blt_core/src/utils.rs:10-45 ``parse_chunk_size_str``,
blt_core/src/utils.rs:79-97 ``determine_thread_count``):

- sizes accept only ASCII digits optionally followed by ``KB`` or ``MB``
  (case-insensitive); trailing/leading whitespace is trimmed; no ``GB``,
  no floats, no bare ``B`` suffix (pinned by utils.rs:52-71 tests).
- thread count: explicit value wins, 0 coerces to 1, otherwise all cores.
"""

from __future__ import annotations

import os


class SizeParseError(ValueError):
    """Invalid chunk-size string (maps to the reference's Err(String))."""


def parse_chunk_size_str(s: str) -> int:
    """Parse '1024', '16KB', '2MB' (case-insensitive) into bytes.

    Grammar pinned by reference tests utils.rs:52-71: rejects '1gb', 'mb1',
    '1024b', '', 'abc', '10.5MB', 'KB', ' MB'.
    """
    s_trimmed = s.strip()
    if not s_trimmed:
        raise SizeParseError("Input string is empty")

    s_upper = s_trimmed.upper()

    if s_upper.endswith("KB") or s_upper.endswith("MB"):
        num_part = s_trimmed[:-2]
        unit = s_upper[-2:]
    elif all(c.isdigit() and c.isascii() for c in s_trimmed):
        num_part = s_trimmed
        unit = ""
    else:
        raise SizeParseError(
            f"Invalid unit or format: '{s_trimmed}'. Number must be followed by "
            "KB, MB, or be raw bytes."
        )

    if not num_part and unit:
        raise SizeParseError(f"Number part missing for unit '{unit}'")

    if not (num_part and all(c.isdigit() and c.isascii() for c in num_part)):
        raise SizeParseError(f"Invalid number: '{num_part}'")
    num = int(num_part)

    if unit == "KB":
        return num * 1024
    if unit == "MB":
        return num * 1024 * 1024
    return num


def determine_thread_count(cli_threads_override: int | None) -> int:
    """Worker count: explicit override (0 -> 1), else all cores (>=1)."""
    if cli_threads_override is not None:
        return cli_threads_override if cli_threads_override > 0 else 1
    cores = os.cpu_count() or 1
    return cores if cores > 0 else 1
