"""Nothing the benchmark loads is JAX, the JAX package, bench.py or
chip_smoke.py (top-level names compared whole: the port's name begins
with the JAX package's), and the reference loads nothing of the port."""

import subprocess
import sys

from ekbench import data

SCRIPT = r"""
import sys, time
from ekbench import harness, data
from ekbench.tests.tiny import E2E, cell, layers
for w in [x["name"] for x in data.benchmark()["workloads"]]:
    c, cfg = cell(w)
    harness.run_cell(c, cfg, 3, 0.0, True, "cpu", E2E, layers(),
                     time.perf_counter())
import ekbench.run, ekbench.control
print(sorted({m.split(".")[0] for m in sys.modules}))
print(harness.forbidden_modules())
"""


def _run(script):
    p = subprocess.run([sys.executable, "-c", script], cwd=data.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()


def test_a_run_loads_no_forbidden_module():
    top, bad = _run(SCRIPT)[-2:]
    assert bad == "[]"
    names = eval(top)
    assert "eigenkernel_tpu_torch" in names
    for name in ("jax", "jaxlib", "flax", "eigenkernel_tpu", "bench",
                 "chip_smoke"):
        assert name not in names


def test_the_yardstick_loads_nothing_of_the_port():
    out = _run("import sys\n"
               "import ekbench.reference, ekbench.roofline, "
               "ekbench.devtrace, ekbench.data\n"
               "import ekbench.gen.elses_like, ekbench.gen.overlap_like\n"
               "print(sorted({m.split('.')[0] for m in sys.modules}))")
    names = eval(out[-1])
    assert "eigenkernel_tpu_torch" not in names
    assert "eigenkernel_tpu" not in names and "jax" not in names


def test_forbidden_names_are_compared_whole():
    from ekbench import harness

    assert harness.forbidden_modules(
        ["eigenkernel_tpu_torch", "eigenkernel_tpu_torch.ops.band",
         "jaxtyping", "benchmark_x", "chip_smoke_x"]) == []
    assert harness.forbidden_modules(
        ["eigenkernel_tpu.ops", "jax.numpy", "jaxlib", "flax", "bench",
         "chip_smoke"]) == ["bench", "chip_smoke", "eigenkernel_tpu",
                            "flax", "jax", "jaxlib"]
