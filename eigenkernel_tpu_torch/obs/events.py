"""Accumulating event logger -> stderr stream + ``log.json``, with spans.

Counterpart of ``eigenkernel_tpu/obs/events.py`` (reference:
event_logger.f90):

* ``add_event(name, val)`` accumulates: events with the same name sum
  ``val`` and bump ``num_repeated``; first-occurrence order is kept.
* Each event is streamed to stderr as ``[Event <t>] name,val``, ``<t>``
  seconds since the logger epoch (the port runs one process, so there is
  no rank filter).
* ``events()`` exports ``[{"name", "num_repeated", "val"}]``, the
  ``events`` array of ``log.json``.

CUDA launches are asynchronous, so a stage's clock stops only after
``torch.cuda.synchronize()`` (:func:`barrier`).

Spans.  A solve's stage runs inside :func:`stage`, which makes the
caller's :class:`EventLog` the *active* log for its length; inside it,
``with span(name):`` records ``(name, start_ns, end_ns, parent)`` on
``time.time_ns()`` (the clock of ``torch.profiler``'s events) into the
active log, and adds the span's seconds to the event of its name (so
``events()`` and ``log.json`` carry each span name's total and count; a
span is not streamed).  With no active log -- no ``log=``, or a log that
is not an :class:`EventLog` -- ``span`` returns one shared
``nullcontext`` and reads no clock.  A span never synchronizes the
device: a wait on the device is a span of its own, ``wait:<site>``,
around the host read that blocks.  While a profiler runs, each span and
each stage is also a ``torch.profiler.record_function`` range.

Counters.  ``count(name, val)`` adds ``val`` to the event of its name in
the active log (not streamed, no span); with no active log it does
nothing.  A counter that needs a host read of a device value asks
:func:`active` first, so that a solve without a log makes no such read.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import torch


@dataclass
class _Event:
    name: str
    num_repeated: int
    val: float


class Span(NamedTuple):
    name: str
    start_ns: int       # time.time_ns(), the profiler's clock
    end_ns: int
    parent: Optional[str]   # the enclosing span or stage, None at the top


def barrier(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class EventLog:
    """Ordered, accumulating event list (reference: linked list of
    events), and the spans recorded while it is the active log."""

    stream: bool = True
    epoch: float = field(default_factory=time.time)
    _events: dict[str, _Event] = field(default_factory=dict)
    _spans: list[Span] = field(default_factory=list)
    _open: list[str] = field(default_factory=list)

    def _accumulate(self, name: str, val: float) -> None:
        ev = self._events.get(name)
        if ev is None:
            self._events[name] = _Event(name, 1, float(val))
        else:
            ev.num_repeated += 1
            ev.val += float(val)

    def add_event(self, name: str, val: float) -> None:
        self._accumulate(name, val)
        if self.stream:
            t = time.time() - self.epoch
            print(f"[Event{t:16.6f}] {name},{val}", file=sys.stderr,
                  flush=True)

    def events(self) -> list[dict[str, Any]]:
        return [
            {"name": e.name, "num_repeated": e.num_repeated, "val": e.val}
            for e in self._events.values()
        ]

    def spans(self) -> list[Span]:
        """The recorded spans and stages, in the order they closed."""
        return list(self._spans)

    def print_events(self, file=None) -> None:
        """Dump all accumulated events (reference: print_events)."""
        file = file or sys.stdout
        print("Events:", file=file)
        for e in self._events.values():
            print(f"  {e.name} ({e.num_repeated} times): {e.val:.6f}", file=file)


_ACTIVE: contextvars.ContextVar[Optional[EventLog]] = \
    contextvars.ContextVar("eigenkernel_active_log", default=None)
_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    """One span (or, with ``is_stage``, a stage: the log made active, its
    seconds left to the stage's ``add_event``) in ``log``, and a
    ``record_function`` range while a profiler runs; ``log`` None gives
    the range alone."""

    __slots__ = ("log", "name", "is_stage", "parent", "start", "rf",
                 "token")

    def __init__(self, log: Optional[EventLog], name: str,
                 is_stage: bool = False):
        self.log, self.name, self.is_stage = log, name, is_stage

    def __enter__(self):
        log = self.log
        if log is not None:
            self.parent = log._open[-1] if log._open else None
            log._open.append(self.name)
            if self.is_stage:
                self.token = _ACTIVE.set(log)
            self.start = time.time_ns()
        self.rf = torch.profiler.record_function(self.name) \
            if _profiling() else None
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        log = self.log
        if log is None:
            return
        end = time.time_ns()
        log._open.pop()
        if self.is_stage:
            _ACTIVE.reset(self.token)
        log._spans.append(Span(self.name, self.start, end, self.parent))
        if not self.is_stage:
            log._accumulate(self.name, (end - self.start) * 1e-9)


def span(name: str):
    """A span of the active log (module doc); the shared no-op context
    when no log is active."""
    log = _ACTIVE.get()
    if log is None:
        return _OFF
    return _Span(log, name)


def active() -> bool:
    """Whether a log is active: spans and counters are being recorded."""
    return _ACTIVE.get() is not None


def count(name: str, val: float) -> None:
    """Add ``val`` to the counter ``name`` of the active log (module
    doc); nothing when no log is active."""
    log = _ACTIVE.get()
    if log is not None:
        log._accumulate(name, val)


def stage(name: str, log: Any):
    """The context of one stage of a solve: ``log``, when an
    :class:`EventLog`, is the active log for its length and records the
    stage's span (its seconds are the stage's ``add_event``); any other
    log gets nothing from it.  While a profiler runs the stage is a
    ``record_function`` range, whatever the log."""
    if isinstance(log, EventLog):
        return _Span(log, name, is_stage=True)
    return _Span(None, name) if _profiling() else _OFF
