"""refine_s (layer: mixed-precision refinement, ``ops/refine.py``):
seconds a solve of the float64 refinement of a ``dtype='mixed'`` solve,
the stage ``solve:refine``, from the traced window's stage events; None
where the solves refine nothing."""


def read(run):
    return run.stage_s("solve:refine")
