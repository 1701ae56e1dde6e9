"""The benchmark of ``eigenkernel_tpu_torch`` on one NVIDIA H100.

``python3 ekbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line
(``harness.py``).  Configurations (``configs/``), cells (``cells/``),
matrix generators (``gen/``) and per-layer metric readers (``metrics/``)
are files found by name; the plain reference (``reference.py``), the
frozen kernel bounds (``roofline.py``) and the trace reading
(``devtrace.py``) are the yardstick, and import nothing of the port.
"""
