"""The spans and counters of one room.

A ``Recorder`` belongs to one room.  A span adds its wall seconds to
``profile[name]`` and appends one ``Event`` to ``events``: the room, its
name, the span open around it on the same thread (its parent), the thread's
name, its start and end on the wall clock (``time.time_ns``, the clock of
``torch.profiler``'s events) and the CPU time the thread spent inside it
(``time.thread_time_ns``).  A counter adds a number to ``profile[name]``.
A key that repeats adds up.  The recorder is pure Python and puts nothing
into a ``torch.profiler`` trace; a span around work queued on the card
measures the enqueue unless it ends in ``utils.device.sync``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional


class Event(NamedTuple):
    room: str
    name: str
    parent: Optional[str]
    thread: str
    start_ns: int
    end_ns: int
    cpu_ns: int


class Recorder:
    """Spans and counters of one room; any thread may record."""

    def __init__(self, room: str = ""):
        self.room = room
        self.profile: Dict[str, float] = {}
        self.events: List[Event] = []
        self._local = threading.local()  # each thread's stack of open spans
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, cpu: Optional[str] = None):
        """Time the block as ``name``; with ``cpu``, also add the thread's
        CPU seconds in it to the counter ``cpu``."""
        stack = self._local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = time.time_ns()
        c0 = time.thread_time_ns()  # read inside the wall interval
        try:
            yield
        finally:
            c1 = time.thread_time_ns()
            t1 = time.time_ns()
            stack.pop()
            self.count(name, (t1 - t0) / 1e9)
            if cpu is not None:
                self.count(cpu, (c1 - c0) / 1e9)
            event = Event(self.room, name, parent, threading.current_thread().name,
                          t0, t1, c1 - c0)
            with self._lock:
                self.events.append(event)

    def count(self, name: str, value: float) -> None:
        with self._lock:
            self.profile[name] = self.profile.get(name, 0.0) + float(value)

    def absorb(self, other: "Recorder") -> None:
        """Add another recorder's counts and events (recorded before this
        room had its recorder) to this room's."""
        for name, value in other.profile.items():
            self.count(name, value)
        with self._lock:
            self.events += [e._replace(room=self.room) for e in other.events]
