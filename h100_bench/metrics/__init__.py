"""One reader a metric, named as in ``BENCHMARK.json``: ``read(window)``
returns the number, or None when the run has nothing for it to read.
They are loaded by file path (``manifest.metric``), so a name may hold dots."""
