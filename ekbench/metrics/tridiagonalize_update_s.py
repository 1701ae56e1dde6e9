"""tridiagonalize_update_s (layer: one-stage tridiagonalization,
``ops/householder.py::tridiagonalize``): seconds a solve of the
program's span ``tridiagonalize:update`` (the rank-2b trailing update
and the write of the panel's V), from the traced window; None where the
program has no such span."""


def read(run):
    return run.stage_s("tridiagonalize:update")
