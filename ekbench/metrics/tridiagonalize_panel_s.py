"""tridiagonalize_panel_s (layer: one-stage tridiagonalization,
``ops/householder.py::tridiagonalize``): seconds a solve of the
program's span ``tridiagonalize:panel`` (the dlatrd column loop, with
its A22 v GEMVs), from the traced window; None where the program has no
such span."""


def read(run):
    return run.stage_s("tridiagonalize:panel")
