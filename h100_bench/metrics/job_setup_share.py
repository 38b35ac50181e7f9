"""The jobs' set-up over the window's seconds (%): the program's
``job.setup`` spans, each from an entry's call to its first ``next()`` on
the engine's results: the argument parse, the configuration with the
merges file's parse, the table, the engine, the output opened. The
encoder and its staging, which the engine's stream builds lazily, come
after it."""

from h100_bench.common import spans


def read(w):
    return spans.share(w, "job.setup")
