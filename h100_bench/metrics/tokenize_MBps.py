"""Input bytes (1e6) of every job completed in the window over the window's
seconds (host clock): the window closes at the end of the first job that
ends after ``--seconds``, so it counts whole jobs only."""


def read(w):
    return sum(j.in_bytes for j in w.jobs) / 1e6 / w.seconds
