"""Device kernels a frame in the profiled clips (copies and memsets left
out), averaged over ranks."""

from harness.trace import is_copy


def read(run, log):
    traces = [r["trace"] for r in run["ranks"] if r["trace"]]
    counts = [sum(c for n, (c, _) in t["ops"].items() if not is_copy(n))
              / t["frames"] for t in traces]
    if not counts or not all(counts):
        log("kernels_per_frame: no kernel in the trace")
        return None
    return sum(counts) / len(counts)
