"""to_band_panel_s (layer: full to band, ``ops/band.py::to_band``):
seconds a solve of the program's span ``to_band:panel`` (each panel's
``_qr_panel`` and ``wy_t_factor``: host launches, nothing waited on),
from the traced window; None where the program has no such span."""


def read(run):
    return run.stage_s("to_band:panel")
