"""Host ms the caller spent in the window's `join_mapping` program spans
(waiting for the asynchronous mapping pass) per keyframe inserted in the
window (its `insert_keyframe` spans)."""
from slambench import spans


def read(run):
    recs = spans.in_window(run)
    keyframes = sum(r.name == "insert_keyframe" for r in recs)
    if not keyframes:
        return None
    return sum((r.t1 - r.t0) / 1e6 for r in recs if r.name == "join_mapping") / keyframes
