"""The device's idle share over the profiled clips, averaged over ranks:
1 - the union of the trace's device intervals over the host-fenced wall
time of those clips (the profiler's own cost included)."""


def read(run, log):
    traces = [r["trace"] for r in run["ranks"] if r["trace"]]
    if not traces or not all(t["busy_s"] > 0 for t in traces):
        log("device_idle_share: no device operation in the trace")
        return None
    return 100.0 * sum(1 - t["busy_s"] / t["window_s"]
                       for t in traces) / len(traces)
