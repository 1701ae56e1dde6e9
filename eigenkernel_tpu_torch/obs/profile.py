"""The join of a profiled solve with its spans (``--profile``).

``summarize(kineto_events, spans)`` takes ``torch.profiler``'s raw events
(``prof.profiler.kineto_results.events()``) and an
:class:`~eigenkernel_tpu_torch.obs.events.EventLog`'s ``spans()``, both on
``time.time_ns()``:

* each device event (kernel, copy, set) is joined to the CUDA runtime or
  driver call that launched it by their correlation id, and the call is
  put down to the innermost span open at its start;
* the window is the spans' hull (the outermost stage: the solve); the
  device's idle gaps in it are named ``<innermost span> > <runtime
  call>``, or ``<innermost span> > python`` where the host was in no
  runtime call, at each gap's midpoint.

For each span name it reports ``count``, ``host_s`` (the spans' seconds),
``self_s`` (less the seconds of the spans that name it their parent), and
``kernels`` and ``device_s``: the device kernels the span launched itself,
outside its child spans, and their device seconds, with the ``top``
kernels by device seconds.  ``launches_outside`` counts the joined calls
that do not lie inside their span on the shared clock.
"""

from __future__ import annotations

from typing import Iterable

NAME_CHARS = 160
TOP = 5


def _innermost(points, intervals) -> list:
    """For each of the sorted ``points``, the index of the innermost of
    ``intervals`` [(start, end, ...)] (sorted by start, longest first;
    properly nested) that holds it, or -1."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(intervals) and intervals[i][0] <= p:
            while stack and intervals[stack[-1]][1] <= intervals[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and intervals[stack[-1]][1] <= p:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def _split(events, span_names):
    """(device events, runtime calls): [(start, end, name, is_kernel,
    correlation ids)] and [(start, end, name, correlation id)].

    Sorted by device and name: PyTorch 2.11's ``_KinetoEvent`` has no
    activity type (2.13's has).  A device event is CUDA's and not the
    device's mirror of a span; a copy or set is named ``Memcpy ...`` or
    ``Memset ...``; a runtime or driver call is the host's and named
    ``cu...``."""
    import torch

    cuda = torch._C._autograd.DeviceType.CUDA
    dev, calls = [], []
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if name not in span_names:
                dev.append((s, e, name,
                            not name.startswith(("Memcpy", "Memset")),
                            (ev.correlation_id(),
                             ev.linked_correlation_id())))
        elif name.startswith("cu"):
            calls.append((s, e, name, ev.correlation_id()))
    return dev, calls


def summarize(kineto_events: Iterable, spans: Iterable) -> dict:
    """The join (module doc) as a JSON-ready dict."""
    spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    if not spans:
        return {"window_s": 0.0, "spans": {}, "gaps": []}
    dev, calls = _split(kineto_events, {s.name for s in spans})

    out = {}
    for s in spans:
        st = out.setdefault(s.name, {"count": 0, "host_s": 0.0,
                                     "self_s": 0.0, "kernels": 0,
                                     "device_s": 0.0, "top": {}})
        st["count"] += 1
        st["host_s"] += (s.end_ns - s.start_ns) * 1e-9
        st["self_s"] += (s.end_ns - s.start_ns) * 1e-9
    # self time: each span's seconds off its parent's
    for s in spans:
        if s.parent in out:
            out[s.parent]["self_s"] -= (s.end_ns - s.start_ns) * 1e-9
    spans = [(s.start_ns, s.end_ns, s.name) for s in spans]
    lo, hi = spans[0][0], max(s[1] for s in spans)

    # device events to their calls, calls to their spans
    calls.sort(key=lambda c: (c[0], -c[1]))
    by_id = {c[3]: i for i, c in enumerate(calls) if c[3]}
    owner = _innermost([c[0] for c in calls], spans)
    kernels = attributed = outside = 0
    seen = set()
    for s, e, name, is_kernel, ids in dev:
        if e <= lo or s >= hi:
            continue
        kernels += is_kernel
        ci = next((by_id[i] for i in ids if i in by_id), None)
        if ci is None or owner[ci] < 0:
            continue
        attributed += is_kernel
        sp = spans[owner[ci]]
        if ci not in seen:
            seen.add(ci)
            c = calls[ci]
            outside += not (sp[0] <= c[0] and c[1] <= sp[1])
        st = out[sp[2]]
        st["kernels"] += is_kernel
        st["device_s"] += (e - s) * 1e-9
        key = name[:NAME_CHARS]
        st["top"][key] = st["top"].get(key, 0.0) + (e - s) * 1e-9
    for st in out.values():
        st["top"] = sorted(([k, v] for k, v in st["top"].items()),
                           key=lambda kv: -kv[1])[:TOP]

    # the device's idle gaps in the window, by span and runtime call
    busy, gaps, cur = 0, [], lo
    for s, e in sorted((d[0], d[1]) for d in dev):
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
    named = {}
    mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
    in_span = _innermost([m for m, _ in mids], spans)
    in_call = _innermost([m for m, _ in mids], calls)
    for (_, dur), si, ci in zip(mids, in_span, in_call):
        where = spans[si][2] if si >= 0 else "(no span)"
        what = calls[ci][2] if ci >= 0 else "python"
        key = f"{where} > {what}"
        named[key] = named.get(key, 0.0) + dur * 1e-9
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy * 1e-9,
        "idle_s": (hi - lo - busy) * 1e-9,
        "kernels": kernels,
        "kernels_attributed": attributed,
        "launches_outside": outside,
        "spans": out,
        "gaps": sorted(([k, v] for k, v in named.items()),
                       key=lambda kv: -kv[1]),
    }
