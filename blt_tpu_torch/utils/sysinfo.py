"""Host resource discovery (total RAM), the sysinfo-crate analog (copy of
``blt_tpu/utils/sysinfo.py``).

Reference: blt_core/src/chunking.rs:33-42 queries total system memory via the
``sysinfo`` crate to derive dynamic chunk sizes.
"""

from __future__ import annotations

import os


def total_memory_bytes() -> int:
    """Total physical RAM in bytes (0 if undiscoverable, like sysinfo)."""
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        pages = os.sysconf("SC_PHYS_PAGES")
        if page > 0 and pages > 0:
            return page * pages
    except (ValueError, OSError, AttributeError):
        pass
    # /proc fallback
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
