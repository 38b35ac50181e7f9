"""The drain stage's share of the window (%): its producing time less its
wait on the stage above it (``stage_stats`` of the program's feeder)."""


def read(w):
    drain = w.stages.get("drain")
    above = w.stages.get("d2h") or w.stages.get("feed")
    if drain is None or above is None:
        return None
    return 100.0 * (drain["src_time"] - above["get_wait"]) / w.seconds
