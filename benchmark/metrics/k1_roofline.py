"""K1's share of its roofline in the profiled clips: the sum of each
frame's K1 bytes (``work/k1.py``, at the frame's executed blocks) over
HBM's rate, over the device time of kernels ``gather_kernel`` and
``pieces_kernel``.  Null where the trace's K1 launches a frame differ from
the configuration's list."""

from work import k1

NAMES = ("::gather_kernel", "::pieces_kernel")


def read(run, log):
    cfg = run["cell"].cfg
    bs = run["block_size"]
    want = sum(len(v) for v in k1.launches(cfg, bs).values())
    shares = []
    for r in run["ranks"]:
        t = r["trace"]
        if not t:
            continue
        ops = [(c, s) for n, (c, s) in t["ops"].items()
               if any(k in n for k in NAMES)]
        launches = sum(c for c, _ in ops)
        if launches != want * t["frames"]:
            log(f"k1_roofline: {launches} K1 launches in {t['frames']} "
                f"frames, the configuration lists {want} a frame")
            return None
        bound = sum(k1.bound_s(cfg, bs, run["total_blocks"] if kind ==
                               "first" else run["capacity"])
                    for kind in t["kinds"])
        shares.append(100.0 * bound / sum(s for _, s in ops))
    if not shares:
        log("k1_roofline: no trace")
        return None
    return sum(shares) / len(shares)
