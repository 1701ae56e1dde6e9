"""band_to_tridiag_s (layer: bulge chase, ``ops/chase.py`` (B3)): seconds
a solve of the stage event ``sep:band_to_tridiag``, from the traced
window."""


def read(run):
    return run.stage_s("sep:band_to_tridiag")
