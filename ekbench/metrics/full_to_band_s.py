"""full_to_band_s (layer: full to band, ``ops/band.py``): seconds a solve
of the stage event ``sep:full_to_band``, from the traced window."""


def read(run):
    return run.stage_s("sep:full_to_band")
