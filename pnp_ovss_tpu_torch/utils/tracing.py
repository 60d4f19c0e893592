"""The port's spans and counters at its own layer boundaries.

``TRACER`` is the one process-wide tracer, off by default. While it is off
``TRACER.span(name)`` hands back one shared null context manager (no clock
read, no allocation) and ``TRACER.count`` is a single branch, so the call
sites cost next to nothing on the timed path. While it is on, each span is
kept in memory as its name, start and end, the index of its parent (the
innermost span open on the same thread), its thread, its batch id (given
to the root span, inherited by every span under it) and its attributes;
nothing is written until ``drain()``.

Spans are stamped with ``time.time_ns()``: Unix nanoseconds, the clock on
which ``torch.profiler`` (kineto) stamps its host events and to which it
converts CUPTI's device timestamps, so a device trace's launches and
kernels can be put down to the span that was open when they were
enqueued.

``chrome_trace`` turns what ``drain()`` returns into a Chrome trace (the
CLI's ``--trace_spans``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()

# A span's record while the tracer holds it (a list, filled in place):
_NAME, _START, _END, _PARENT, _TID, _BATCH, _ATTRS = range(7)


class _Span:
    __slots__ = ("tracer", "name", "batch", "attrs", "rec")

    def __init__(self, tracer: "Tracer", name: str, batch: Optional[int],
                 attrs: Dict):
        self.tracer, self.name, self.batch, self.attrs = (tracer, name, batch,
                                                          attrs)

    def __enter__(self):
        stack = self.tracer._stack()
        parent = stack[-1] if stack else None
        batch = self.batch
        if batch is None and parent is not None:
            batch = parent[_BATCH]
        self.rec = [self.name, time.time_ns(), None, parent,
                    threading.get_ident(), batch, self.attrs]
        self.tracer._spans.append(self.rec)
        stack.append(self.rec)
        return None

    def __exit__(self, *exc):
        self.rec[_END] = time.time_ns()
        self.tracer._stack().pop()
        return False


class Tracer:
    def __init__(self):
        self.enabled = False
        self._spans: List[list] = []
        self._counters: Dict[str, int] = defaultdict(int)
        self._local = threading.local()
        self._batch_ids = itertools.count()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def new_batch(self) -> int:
        """A batch id, unique in the process (drawn whether or not the
        tracer is on, so ids never repeat across an ``enable()``)."""
        return next(self._batch_ids)

    def span(self, name: str, batch: Optional[int] = None, **attrs):
        """A context manager timing the enclosed block. ``batch`` marks a
        root span's batch; a span without one takes its parent's."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, batch, attrs)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self._counters[name] += n

    def _stack(self) -> List[list]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def drain(self) -> Dict:
        """The spans recorded since the last drain, in the order they
        opened, and the counters; both are cleared. Each span: ``name``,
        ``start_ns``, ``end_ns`` (None while still open), ``parent`` (index
        in this list, -1 for a root or a parent drained earlier), ``tid``,
        ``batch`` and ``attrs``. Call it where no span is being opened."""
        spans, self._spans = self._spans, []
        counters, self._counters = dict(self._counters), defaultdict(int)
        index = {id(r): i for i, r in enumerate(spans)}
        return {"spans": [
            {"name": r[_NAME], "start_ns": r[_START], "end_ns": r[_END],
             "parent": -1 if r[_PARENT] is None
             else index.get(id(r[_PARENT]), -1),
             "tid": r[_TID], "batch": r[_BATCH], "attrs": r[_ATTRS]}
            for r in spans], "counters": counters}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name over the closed spans not yet drained: total and
        mean seconds and the count."""
        totals: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for r in self._spans:
            if r[_END] is not None:
                totals[r[_NAME]] += (r[_END] - r[_START]) * 1e-9
                counts[r[_NAME]] += 1
        return {
            name: {
                "total_s": round(totals[name], 4),
                "count": counts[name],
                "mean_s": round(totals[name] / counts[name], 4),
            }
            for name in totals
        }


TRACER = Tracer()


def chrome_trace(drained: Dict, pid: int = 0) -> Dict:
    """What ``Tracer.drain()`` returned as a Chrome trace (the JSON object
    format, times in microseconds): one complete ("X") event a closed span,
    ``pid`` the rank, ``tid`` the thread, the batch id and the attributes
    in ``args``; one counter ("C") event a counter, at the last span's
    end."""
    events, last = [], 0
    for s in drained["spans"]:
        if s["end_ns"] is None:
            continue
        last = max(last, s["end_ns"])
        events.append({"name": s["name"], "ph": "X", "pid": pid,
                       "tid": s["tid"], "ts": s["start_ns"] / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": dict(s["attrs"], batch=s["batch"])})
    for name, value in sorted(drained["counters"].items()):
        events.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                       "ts": last / 1e3, "args": {name: value}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
