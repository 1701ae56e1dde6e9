"""A tiny configuration and cells that live only in the tests: the
harness's whole control flow on the CPU in a second or so."""

import copy

from ekbench import data

TINY_GEN = {
    "name": "tiny_gen", "n": 80, "dtype": "float64",
    "matrices": {
        "a": {"gen": "elses_like", "band": 8, "decay": 4.0,
              "long_frac": 0.05, "long_scale": 0.05},
        "b": {"gen": "overlap_like", "pattern": "a", "scale": 0.2,
              "decay": 4.0},
    },
}
TINY = dict(TINY_GEN, name="tiny",
            matrices={"a": TINY_GEN["matrices"]["a"]})
E2E = {"setup_s": "s", "solve_s": "s", "peak_mem_gib": "GiB"}


def cell(workload: str) -> dict:
    """The benchmark's own cell, on the tiny configuration of its kind
    (the limits are the cell's)."""
    c = copy.deepcopy(data.cell(workload))
    cfg = TINY_GEN if "b" in data.config(c["config"])["matrices"] else TINY
    if c.get("n_vec") is not None:
        c["n_vec"] = 12
    return c, cfg


def layers() -> dict:
    return {m["name"]: m["unit"] for m in data.benchmark()["per_layer"]}
