"""The benchmark of ``blockcopy_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  Prints
the compared numbers beside their limits as the last lines of standard
error, and one JSON object as the last line of standard output.  Exits
non-zero, printing no result, where CUDA or enough cards are missing, or
where JAX, jaxlib, flax or the JAX package was loaded, in this process or
in a clip-parallel rank.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from harness.modules import forbidden_modules  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["USE_FLAX"] = "0"
    import torch
    print(f"{time.time() - T0:.2f} s: torch imported", file=sys.stderr)
    from harness import cell as cells
    from harness import main as harness_main
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, in_ranks = harness_main.run(cell, args.seed, args.seconds,
                                        bool(args.trace), T0)
    bad = sorted(set(forbidden_modules()) | set(in_ranks))
    if bad:
        print(f"loaded in the process that prints the result or in a "
              f"rank: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
