"""The feed's host copy over the window's seconds (%): the program's
``feed.pack`` spans, each the copy of one batch into pinned staging
(``feeder.pack_into``), page faults of the mapped input included."""

from h100_bench.common import spans


def read(w):
    return spans.share(w, "feed.pack")
