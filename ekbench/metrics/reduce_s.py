"""reduce_s (layer: generalized reduction and recovery,
``ops/reduction.py``, ``ops/blocked.py``): seconds a solve of the
reduction and the recovery, from the traced window's stage events."""


def read(run):
    return run.stage_s("solve:reduce_elpa", "reduce_generalized",
                       "reduce_generalized_new", "recovery_generalized")
