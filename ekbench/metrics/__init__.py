"""Per-layer metric readers, one file a metric (``metrics/<name>.py``).

Each defines ``read(run)`` of a :class:`ekbench.harness.LayerRun` and
returns one number, or None where the cell does not run its layer."""
