"""The multipass loop over the window's seconds (%): the program's
``mp.chunk`` spans, each one chunk's passes until none merges as the feed
thread dispatches them (the plain twin's ``multipass_encode``, or the
kernel route's loop), the host reads between passes included."""

from h100_bench.common import spans


def read(w):
    return spans.share(w, "mp.chunk")
