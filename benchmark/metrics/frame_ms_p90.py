"""The 90th percentile of every frame's time in the window, on every rank:
the interval between consecutive frames' completion events (the first
from an event at the window's start)."""

import numpy as np


def read(run, log):
    times = [t for r in run["ranks"] for t in r["intervals_ms"]]
    log(f"frame_ms_p90 over {len(times)} frames")
    return float(np.percentile(times, 90))
