"""K2's share of its roofline in the profiled clips: the sum of each
frame's tail bounds (``work/k2.py``: each tail's larger of operations over
the peak and bytes over HBM's rate, at the frame's executed blocks) over
the device time of kernels ``tail_bf16``, ``tail_band`` and
``tail_f32``.  Null where the trace's K2 launches a frame differ from the
configuration's list of tails."""

from work import k2

NAMES = ("tail_bf16", "tail_band", "tail_f32")


def read(run, log):
    cfg = run["cell"].cfg
    bs = run["block_size"]
    want = len(k2.tails(cfg, bs)) * k2.launches_per_tail(cfg["dtype"])
    shares = []
    for r in run["ranks"]:
        t = r["trace"]
        if not t:
            continue
        ops = [(c, s) for n, (c, s) in t["ops"].items()
               if any(k in n for k in NAMES)]
        launches = sum(c for c, _ in ops)
        if launches != want * t["frames"]:
            log(f"k2_roofline: {launches} K2 launches in {t['frames']} "
                f"frames, the tails list {want} a frame")
            return None
        bound = sum(k2.bound_s(cfg, bs, run["total_blocks"] if kind ==
                               "first" else run["capacity"])
                    for kind in t["kinds"])
        shares.append(100.0 * bound / sum(s for _, s in ops))
    if not shares:
        log("k2_roofline: no trace")
        return None
    return sum(shares) / len(shares)
