"""to_band_update_s (layer: full to band, ``ops/band.py::to_band``):
seconds a solve of the program's span ``to_band:update`` (A V, u, the
trailing rank-2b updates and the write of V2 and taus), from the traced
window; None where the program has no such span."""


def read(run):
    return run.stage_s("to_band:update")
