"""The output writer's busy time over the window's seconds (%): the
program's ``write`` spans, each one ``OutputWriter.write`` on the writer's
thread."""

from h100_bench.common import spans


def read(w):
    return spans.share(w, "write")
