"""Run one cell of the benchmark once and print its result line.

    python3 ekbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line carries the
cell's end-to-end metrics of ``BENCHMARK.json``, with ``--trace 1`` its
per-layer metrics (``harness.py``).  It exits non-zero and prints no line
without enough CUDA devices, or if a forbidden module (``jax``,
``jaxlib``, ``flax``, ``eigenkernel_tpu``, ``bench``, ``chip_smoke``,
by whole top-level name) is loaded once the window has closed.  Kernel
and compiler caches stay at fixed paths inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT
CACHE = os.path.join(ROOT, ".ekbench_cache")


def _metrics(bench: dict, kind: str, workload: str) -> dict:
    """{name: unit} of the ``kind`` metrics the workload reports."""
    return {m["name"]: m["unit"] for m in bench[kind]
            if workload in m.get("workloads", [workload])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from ekbench import data, harness

    bench = data.benchmark()
    work = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if work is None:
        harness.say(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = data.cell(args.workload)
    cfg = data.config(cell["config"])
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = os.path.join(CACHE, sub)
    os.environ.update({k: str(v) for k, v in cell.get("env", {}).items()})

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(work["chips"]):
        harness.say(f"needs {work['chips']} CUDA device(s); found {found}")
        return 2
    result = harness.run_cell(
        cell, cfg, args.seed, args.seconds, bool(args.trace),
        "cuda", _metrics(bench, "end_to_end", args.workload),
        _metrics(bench, "per_layer", args.workload), T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.say(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    harness.say(f"card {harness.power_limit()}")
    for key, c in result["checks"].items():
        harness.say(f"check {key} {c['value']!r} limit {c['limit']!r}")
    print(harness.line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
