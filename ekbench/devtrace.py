"""One solve under ``torch.profiler``, read into device time, idle gaps
and kernel times.

The profiler records the card's activity (CUDA activity alone: the
host's operators would be millions more events, too slow to record and
read within a run) and the CUDA runtime calls; the traced window is the
solve's interval on the host clock (``time.time_ns``, the profiler's
clock), and the solve's stages come from its own event log, stamped on
the same clock.  The reading takes the raw events in memory and writes
nothing to disk:

* ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets) inside the window;
* ``kernels``: the count of device kernels in the window (copies and
  sets left out);
* ``by_name``: device seconds by kernel name;
* ``gaps``: idle seconds by what the host was doing while the device
  waited: the solve's stage (``sep:*``, ``solve:*``, ``reduce_*``,
  ``recovery_*``) and the runtime call that held the gap's midpoint
  (none: the host was in Python).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

STAGE_PREFIXES = ("sep:", "solve:", "reduce_", "recovery_")
NAME_CHARS = 160


@dataclass
class Trace:
    """What one profiled solve showed; ``seconds`` holds the reading's
    own costs and the device time outside the window (0 when the
    profiler's clock is the host's)."""
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: int = 0
    by_name: dict = field(default_factory=dict)
    gaps: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def kernel_ms(self, part: str) -> float:
        """Device milliseconds of the kernels whose name holds ``part``."""
        return 1e3 * sum(s for name, s in self.by_name.items()
                         if part in name)

    def breakdown(self, top: int = 10) -> dict:
        def best(d):
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.by_name), "idle_gaps": best(self.gaps)}


def union(intervals, lo: int, hi: int):
    """(busy, gaps) of ``intervals`` [(start, end)] clipped to [lo, hi]:
    the length of their union and the uncovered intervals in order."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def name_gaps(gaps, host, stages=()):
    """{name: seconds} of the idle ``gaps`` [(start, end)] in ns, each
    named by the stage [(start, end, name)] and the innermost host event
    [(start, end, name)] (properly nested, one thread) open at its
    midpoint: "<stage> > <host event>"."""
    host = sorted(host, key=_first_two)
    stages = sorted(stages)
    out, stack, i, j = {}, [], 0, 0
    for mid, dur in sorted(((s + e) // 2, e - s) for s, e in gaps):
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        while j < len(stages) and stages[j][1] <= mid:
            j += 1
        stage = stages[j][2] if j < len(stages) and stages[j][0] <= mid \
            else None
        inner = stack[-1][2] if stack else None
        name = " > ".join(x for x in (stage, inner) if x) or "(no host op)"
        out[name] = out.get(name, 0.0) + dur * 1e-9
    return out


def _first_two(h):
    return h[0], -h[1]


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver")
OVERHEAD = ("Activity Buffer Request", "Command Buffer Full",
            "Buffer Flush")


def read(events, lo: int, hi: int, stages=()) -> Trace:
    """A :class:`Trace` of the profiler's kineto events in the window
    [lo, hi] (ns).  The device's activity is its kernels, copies and sets
    (device-side mirrors of host spans left out); the host's, its
    operators and CUDA runtime and driver calls (the profiler's own
    bookkeeping left out).  One pass over millions of events."""
    import torch

    if not events:
        return Trace(window_s=(hi - lo) * 1e-9)
    # PyTorch 2.11 gives no activity type; later versions do
    kind = getattr(type(events[0]), "activity_type", None)
    start, dur = type(events[0]).start_ns, type(events[0]).duration_ns
    cuda = torch._C._autograd.DeviceType.CUDA
    host, dev = [], []
    for ev in events:
        s = start(ev)
        k = None if kind is None else kind(ev)
        if ev.device_type() == cuda:
            if k is None or k in DEVICE_KINDS:
                dev.append((s, s + dur(ev), ev.name(), k))
        elif k is None or k in HOST_KINDS:
            host.append((s, s + dur(ev), ev.name()))
    if kind is None:
        # no activity types: leave out the mirrors of the host's spans
        # and the profiler's bookkeeping
        dev = [d for d in dev if not d[2].startswith(STAGE_PREFIXES)]
        host = [h for h in host if h[2] not in OVERHEAD
                and not h[2].startswith(STAGE_PREFIXES)]
    total = sum(d[1] - d[0] for d in dev)
    dev = [d for d in dev if d[1] > lo and d[0] < hi]
    busy, gaps = union([(d[0], d[1]) for d in dev], lo, hi)
    by_name = {}
    for s, e, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + 1e-9 * (min(e, hi)
                                                       - max(s, lo))
    host = [h for h in host if h[1] > lo and h[0] < hi]
    kernels = sum(1 for d in dev if d[3] == "kernel" or (
        d[3] is None and not d[2].startswith(("Memcpy", "Memset"))))
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                 kernels=kernels, by_name=by_name,
                 gaps=name_gaps(gaps, host, stages),
                 seconds={"device_outside_window": 1e-9 * (total - sum(
                     min(e, hi) - max(s, lo) for s, e, _, _ in dev))})


class StampedLog:
    """The profiled solve's event log (the program's ``SolverContext``
    calls ``add_event`` at each stage's end, after a synchronize): each
    stage as (start ns, end ns, name) on the profiler's clock."""

    def __init__(self):
        self.stamps = []

    def add_event(self, name: str, val: float) -> None:
        if not name.startswith("!"):      # not a stage's model GFLOP/s
            end = time.time_ns()
            self.stamps.append((end - int(val * 1e9), end, name))


def profile(fn, device, log: StampedLog):
    """``fn(log)`` (one solve) under the profiler, synchronized: (its
    result, :class:`Trace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with prof(activities=acts) as p:
        t0 = time.perf_counter()
        lo = time.time_ns()
        out = fn(log)
        if cuda:
            torch.cuda.synchronize(device)
        hi = time.time_ns()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    events = p.profiler.kineto_results.events()
    tr = read(events, lo, hi, log.stamps)
    tr.seconds.update(solve=t1 - t0, stop=t2 - t1,
                      read=time.perf_counter() - t2, events=len(events))
    return out, tr
