"""Device time of NCCL's all-reduce kernels a train frame on rank 0, in
the profiled clips: the policy gradients' average inside the train
graph."""


def read(run, log):
    t = run["ranks"][0]["trace"]
    if not t:
        log("allreduce_ms: no trace")
        return None
    s = sum(v[1] for n, v in t["ops"].items()
            if n.startswith("ncclDevKernel_AllReduce")
            or n.startswith("ncclKernel_AllReduce"))
    trains = sum(k == "train" for k in t["kinds"])
    if s <= 0 or not trains:
        log("allreduce_ms: no all-reduce kernel in the trace")
        return None
    return s / trains * 1e3
