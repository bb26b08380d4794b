"""From process start to the window's start on the slowest rank: weights,
traffic, kernel builds (a checkout's first run), and the first clip, which
captures the graphs."""


def read(run, log):
    return max(r["setup_s"] for r in run["ranks"])
