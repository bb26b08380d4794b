"""The host's time in each ``first_step`` / ``step`` call (the captured
graph's input copies and replay, no sync), a frame, over the window of
the traced run; a span from the benchmark around the call into the
program's compiled steps."""


def read(run, log):
    ranks = run["ranks"]
    return 1e3 * sum(r["submit_s"] / r["frames"] for r in ranks) / len(ranks)
