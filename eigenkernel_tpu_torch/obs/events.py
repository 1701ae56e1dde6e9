"""Accumulating event logger -> stderr stream + ``log.json``.

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
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch


@dataclass
class _Event:
    name: str
    num_repeated: int
    val: float


def barrier(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class EventLog:
    """Ordered, accumulating event list (reference: linked list of events)."""

    stream: bool = True
    epoch: float = field(default_factory=time.time)
    _events: dict[str, _Event] = field(default_factory=dict)

    def add_event(self, name: str, val: float) -> None:
        ev = self._events.get(name)
        if ev is None:
            self._events[name] = _Event(name, 1, float(val))
        else:
            ev.num_repeated += 1
            ev.val += float(val)
        if self.stream:
            t = time.time() - self.epoch
            print(f"[Event{t:16.6f}] {name},{val}", file=sys.stderr, flush=True)

    def events(self) -> list[dict[str, Any]]:
        return [
            {"name": e.name, "num_repeated": e.num_repeated, "val": e.val}
            for e in self._events.values()
        ]

    def print_events(self, file=None) -> None:
        """Dump all accumulated events (reference: print_events)."""
        file = file or sys.stdout
        print("Events:", file=file)
        for e in self._events.values():
            print(f"  {e.name} ({e.num_repeated} times): {e.val:.6f}", file=file)
