"""kernels_per_solve (layer: device, the host launch path): the device
kernels of the profiled solve (copies and sets left out)."""


def read(run):
    t = run.trace
    if t is None or t.kernels <= 0:
        return None
    return float(t.kernels)
