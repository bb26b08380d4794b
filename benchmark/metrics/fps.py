"""Frames completed a second: every rank's frames in the window, over the
time from the first submission to the synchronize after the last."""


def read(run, log):
    ranks = run["ranks"]
    return sum(r["frames"] for r in ranks) / max(r["window_s"] for r in ranks)
