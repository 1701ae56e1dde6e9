"""tridiagonalize_s (layer: one-stage tridiagonalization,
``ops/householder.py``): seconds a solve of the stage event
``sep:tridiagonalize``, from the traced window."""


def read(run):
    return run.stage_s("sep:tridiagonalize")
