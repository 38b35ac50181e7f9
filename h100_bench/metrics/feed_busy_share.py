"""The feed stage's share of the window (%): its producing time, which
waits on no stage (``stage_stats`` of the program's feeder)."""


def read(w):
    feed = w.stages.get("feed")
    if feed is None:
        return None
    return 100.0 * feed["src_time"] / w.seconds
