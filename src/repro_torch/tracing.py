"""Host spans on the profiler's clock.

``with span("query.rescore"): ...`` records the name, the start and end in
Unix nanoseconds (``time.time_ns``, the clock ``torch.profiler``'s events
are converted to, so a span can be laid over a device trace), the id of the
enclosing span on this thread (``parent``, 0 at the top) and ``call``: a
span with no parent starts a call of its own id, and every span under it
carries that id.  The log keeps the last ``LOG_SPANS`` spans, in the order
they ended; ``spans()`` reads it and ``clear()`` empties it.  A thread that
works for another's span (a device slot's worker) runs under it with
``inside(current())`` taken on the other thread.  Spans are always on: one
costs a few microseconds of host time.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

__all__ = ["Span", "span", "current", "inside", "spans", "clear", "LOG_SPANS"]

LOG_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int        # 0 while the span is open
    id: int
    parent: int        # 0: no enclosing span
    call: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_LOG: collections.deque = collections.deque(maxlen=LOG_SPANS)
_IDS = itertools.count(1)
_HERE = threading.local()


def current() -> Optional[Span]:
    """This thread's innermost open span (None outside any)."""
    return getattr(_HERE, "span", None)


@contextlib.contextmanager
def inside(parent: Optional[Span]) -> Iterator[None]:
    """Run this thread's spans under ``parent`` (an open span of another
    thread, from its ``current()``)."""
    before = current()
    _HERE.span = parent
    try:
        yield
    finally:
        _HERE.span = before


@contextlib.contextmanager
def span(name: str) -> Iterator[Span]:
    """Record ``name`` from entry to exit; yields the open span."""
    parent = current()
    sid = next(_IDS)
    opened = Span(name, time.time_ns(), 0, sid, parent.id if parent else 0,
                  parent.call if parent else sid)
    _HERE.span = opened
    try:
        yield opened
    finally:
        _HERE.span = parent
        _LOG.append(opened._replace(end_ns=time.time_ns()))


def spans() -> List[Span]:
    """The logged spans, oldest first."""
    return list(_LOG)


def clear() -> None:
    _LOG.clear()
