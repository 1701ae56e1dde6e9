"""host_wait_s (layer: device): seconds a solve the host waited for the
device, the program's ``wait:*`` spans together, from the traced window,
which runs without the profiler; None where the program has no such span.
Two kinds: every host read of a device value inside a solve, and
``wait:drain``, each stage's closing synchronize, which a solve makes
only when it is given a log: an untraced solve goes on launching the next
stage instead, so ``solve_s`` less this metric is no measure of the
host's own work."""


def read(run):
    return run.stage_s(*[n for n in run.events if n.startswith("wait:")])
