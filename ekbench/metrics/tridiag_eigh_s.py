"""tridiag_eigh_s (layer: tridiagonal eigensolver, ``ops/dc.py`` + D1,
``ops/sturm.py`` (B1), ``ops/tridiag_solve.py`` (B2)): seconds a solve
of the stage event ``sep:tridiag_eigh``, from the traced window."""


def read(run):
    return run.stage_s("sep:tridiag_eigh")
