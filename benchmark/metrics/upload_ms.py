"""Host-to-device copy time a frame in the profiled clips: the frame's
upload from pinned memory (``device.to_device``)."""


def read(run, log):
    traces = [r["trace"] for r in run["ranks"] if r["trace"]]
    vals = [sum(s for n, (_, s) in t["ops"].items()
                if n.startswith("Memcpy HtoD")) / t["frames"] * 1e3
            for t in traces]
    if not vals or not all(vals):
        log("upload_ms: no host-to-device copy in the trace")
        return None
    return sum(vals) / len(vals)
