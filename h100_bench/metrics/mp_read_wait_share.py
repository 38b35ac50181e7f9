"""The multipass loop's host reads over the window's seconds (%): the
program's ``mp.read`` spans, each the one read a pass of whether another
pass runs, in which the feed thread waits on the card."""

from h100_bench.common import spans


def read(w):
    return spans.share(w, "mp.read")
