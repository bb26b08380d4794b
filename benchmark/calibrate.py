"""The readings a cell's limits are set from, on the card, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds <a,b,...> \
        [--control-seeds <x,y,z>] [--fault-seeds <u,v,w>] \
        [--faults lr2,sq] [--seconds <s>]

For each of ``--seeds``, a run of the program as ``run.py`` makes it (its
set-up, a window of ``--seconds``, its recorded clips judged by the
reference), printing each compared number.  For each of
``--control-seeds``, the control: the reference itself in the program's
place, computed in the precision below the configuration's (the model's
bf16 -> fp8, fp32 with TF32 -> bf16; the policy's bf16 -> fp8), serving
two clips of the cell's traffic from the
benchmark's initial policy, judged by the float32 reference as a run's
clips are.  For each of ``--fault-seeds``, a run of the program with each
of ``--faults`` (``OPTIM_FAULTS``) planted in its RMSprop.  One JSON line each on
standard output.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from reference import plain_fp32  # noqa: E402

# faults planted in the program's RMSprop (``policy/optim.py`` ``update``
# and ``update_``, which its steppers call with ``lr`` by keyword): a
# doubled learning rate; square averages left unchanged (alpha 1)
OPTIM_FAULTS = {"lr2": lambda kw: dict(kw, lr=2 * kw["lr"]),
                "sq": lambda kw: dict(kw, alpha=1.0)}


def faulty_rmsprop(fault: str) -> dict:
    """The program's RMSprop ``update`` and ``update_`` with
    ``OPTIM_FAULTS[fault]`` planted, by name."""
    from blockcopy_tpu_torch.policy import optim
    change = OPTIM_FAULTS[fault]
    return {name: (lambda *a, _f=getattr(optim, name), **kw:
                   _f(*a, **change(kw))) for name in ("update", "update_")}


@contextlib.contextmanager
def planted(fault: str):
    """The program's RMSprop with ``OPTIM_FAULTS[fault]`` while open."""
    from blockcopy_tpu_torch.policy import optim
    saved = optim.update, optim.update_
    optim.update, optim.update_ = faulty_rmsprop(fault).values()
    try:
        yield
    finally:
        optim.update, optim.update_ = saved


@plain_fp32()
def control_gaps(cell, seed: int, device, clips: int = 2) -> dict:
    """The control's worst gaps over ``clips`` clips served one after the
    other, the policy carried from one to the next."""
    import torch
    from harness import traffic
    from harness.weights import as_fp32, realize, sub_seed
    from harness.window import initial_policy, model_spec
    from reference.clip import Start, Task, run_clip
    cfg, tr = cell.cfg, cell.traffic
    p = as_fp32(realize(model_spec(cfg), sub_seed(seed, 1),
                        getattr(torch, cfg["dtype"]), device))
    pol0 = initial_policy(cfg, seed, device)
    part = lambda pre: {k[len(pre):]: v for k, v in pol0.items()
                        if k.startswith(pre)}
    start = Start(part("params/"), part("sq/"), pol0["running_cost"])
    host = traffic.host_clips(tr, cfg, seed, 0, getattr(torch, cfg["dtype"]),
                              device)
    draws = traffic.draws(tr, cfg, seed, 0, device)
    task = Task(cfg, (cfg["height"], cfg["width"]), tr["block_size"])
    gh = cfg["height"] // tr["block_size"]
    gw = cfg["width"] // tr["block_size"]
    capacity = max(1, int(round(cfg["target"] * gh * gw)))
    gaps = {}
    for c in range(clips):
        slot = c % tr["clips"]
        frames = [f.to(device).permute(0, 3, 1, 2).float()
                  for f in host[slot]]
        served, _ = run_clip(task, p, frames, draws[slot], start, capacity,
                             cfg["control"]["model"],
                             policy_prec=cfg["control"]["policy"])
        _, g = run_clip(task, p, frames, draws[slot], start, capacity,
                        "fp32", served)
        for k, v in g.items():
            gaps[k] = max(gaps.get(k, 0.0), v)
        last_sq = served.sq[max(served.sq)] if served.sq else start.sq
        # the next clip starts where this one's policy ended (its running
        # cost near the target); both sides are handed the same start
        start = Start(served.params_end, last_sq,
                      torch.full((), cfg["target"], device=device))
    return gaps


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(OPTIM_FAULTS))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    import torch
    from harness import cell as cells
    from harness.window import serve_rank
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.set_num_threads(2)
    seeds = lambda text: [int(x) for x in text.split(",") if x]
    runs = [("program", s, None) for s in seeds(args.seeds)] + \
        [("control", s, None) for s in seeds(args.control_seeds)] + \
        [("fault", s, f) for f in args.faults.split(",") if f
         for s in seeds(args.fault_seeds)]
    for side, s, fault in runs:
        t0 = time.time()
        line = {"side": side, "fault": fault, "seed": s}
        if side == "control":
            line["gaps"] = control_gaps(cell, s, dev)
        else:
            with planted(fault) if fault else contextlib.nullcontext():
                r = serve_rank(cell, s, args.seconds, False, t0, dev)
            line.update(gaps=r["gaps"], frames=r["frames"],
                        recorded=r["recorded"])
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
