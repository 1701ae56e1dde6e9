"""Readings of a cell's compared numbers, several seeds in one process.

    python3 ekbench/control.py --workload <cell> --seeds 1,2,3 [--dtype float32]

Each seed runs the cell as ``run.py`` does, without the warm solve and
with a window of one solve, the cell's ``dtype`` replaced by ``--dtype``,
and prints one JSON line: the seed, the dtype, each compared number
beside the cell's limit, and whether the run came out correct.  With the
cell's own dtype it gives the program's readings (the lower ones of a
limit); with ``float32`` on a float64 cell it is the control, the port's
own lower-precision path, which has to come out not correct (the upper
readings).  The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT


def readings(cell: dict, cfg: dict, seeds, dtype: str, device) -> list:
    """One result per seed, the cell's dtype replaced by ``dtype``."""
    from ekbench import harness

    cell = dict(cell, dtype=dtype)
    out = []
    for seed in seeds:
        t = time.perf_counter()
        res = harness.run_cell(cell, cfg, seed, 0.0, False, device,
                               {"solve_s": "s"}, {}, t, warm=False)
        out.append({"seed": seed, "dtype": dtype, "correct": res["correct"],
                    "solve_s": res["metrics"]["solve_s"]["value"],
                    "checks": res["checks"]})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--dtype", default=None)
    args = p.parse_args(argv)

    from ekbench import data

    cell = data.cell(args.workload)
    cfg = data.config(cell["config"])
    os.environ.update({k: str(v) for k, v in cell.get("env", {}).items()})

    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(cell, cfg, seeds, args.dtype or cell["dtype"], "cuda"):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
