"""back_transform_s (layer: back-transform, ``ops/wf_bt.py`` (B4),
``householder.apply_wy`` / ``apply_q``): seconds a solve of the stage
event ``sep:back_transform``, from the traced window."""


def read(run):
    return run.stage_s("sep:back_transform")
