"""The program's spans (``pnp_ovss_tpu_torch.utils.tracing.TRACER``) laid
over a device trace (``torch.profiler``, CUDA activity), on the clock both
share: Unix nanoseconds.

Each device op (kernel, copy, set) is put down to the innermost span open
on the submitting thread (the thread of the ``runner.submit`` spans) at
the host time of its launch call: the CUDA runtime or driver call with the
op's correlation id. The call is matched by time, whatever thread made it:
the autograd engine launches the tap backward from its own thread while
the submitting thread waits inside ``bert.gradcam``.

Per-batch numbers use whole batches: those whose ``runner.submit`` began
after the profiler started and whose ``runner.result`` ended before it
stopped, found by the batch id their spans share. Host numbers use the
untraced batches: those wholly inside the window that no traced stretch
touches.

What the readers take (``ctx["spans"]``: what ``TRACER.drain()`` returned,
with ``window_ns``, the window's start and end; ``ctx["trace"]["events"]``:
``events_of(prof)``; ``ctx["trace"]["traced_ns"]``: the profiler's start
and stop). Each reader returns None where either is missing.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Set, Tuple

from port_bench import devtrace

Op = Tuple[str, int, int, int]  # name, start ns, end ns, correlation id
Call = Tuple[str, int, int, int]  # name, start ns, end ns, thread id
OUTSIDE = "(outside)"


def events_of(prof) -> Dict:
    """The trace's device ops, by start, and the launch call of each (by
    correlation id), with absolute times. The calls are the CUDA runtime
    and driver calls (``cuda*``, ``cu*``): the profiler's own host events
    may carry the same correlation ids."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops: List[Op] = []
    host: Dict[int, Call] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ops.append((e.name(), e.start_ns(), e.end_ns(),
                        e.correlation_id()))
        elif e.name().startswith("cu"):
            host[e.correlation_id()] = (e.name(), e.start_ns(), e.end_ns(),
                                        e.start_thread_id())
    ops.sort(key=lambda o: o[1])
    calls = {o[3]: host[o[3]] for o in ops if o[3] in host}
    return {"ops": ops, "calls": calls}


def submitting_thread(spans: Sequence[Dict]) -> Optional[int]:
    for s in spans:
        if s["name"] == "runner.submit":
            return s["tid"]
    return None


def innermost(spans: Sequence[Dict], times: Sequence[int]) -> List[int]:
    """For each time, the index of the innermost span of the submitting
    thread open then (start <= t <= end), or -1. Spans of one thread
    nest, so a sweep with a stack finds it."""
    tid = submitting_thread(spans)
    order = sorted((i for i, s in enumerate(spans) if s["tid"] == tid),
                   key=lambda i: (spans[i]["start_ns"], -_end(spans[i])))
    out = [-1] * len(times)
    stack: List[int] = []
    k = 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        t = times[j]
        while k < len(order) and spans[order[k]]["start_ns"] <= t:
            s = order[k]
            k += 1
            while stack and _end(spans[stack[-1]]) < spans[s]["start_ns"]:
                stack.pop()
            stack.append(s)
        while stack and _end(spans[stack[-1]]) < t:
            stack.pop()
        out[j] = stack[-1] if stack else -1
    return out


def _end(s: Dict) -> float:
    return float("inf") if s["end_ns"] is None else s["end_ns"]


def attribute(spans: Sequence[Dict], events: Dict) -> List[int]:
    """Each op's span (its index in ``spans``, -1 for none): the innermost
    span open at its launch call's start. An op without a call keeps -1."""
    calls = events["calls"]
    ops = events["ops"]
    times = [calls[o[3]][1] if o[3] in calls else -1 for o in ops]
    found = innermost(spans, times)
    return [f if o[3] in calls else -1 for o, f in zip(ops, found)]


def whole_batches(spans: Sequence[Dict], start_ns: int,
                  stop_ns: int) -> Set[int]:
    """Batch ids whose submit began after ``start_ns`` and whose result
    ended before ``stop_ns``."""
    began = {s["batch"] for s in spans if s["name"] == "runner.submit"
             and s["start_ns"] >= start_ns}
    ended = {s["batch"] for s in spans if s["name"] == "runner.result"
             and s["end_ns"] is not None and s["end_ns"] <= stop_ns}
    return began & ended


def batch_extents(spans: Sequence[Dict]) -> Dict[int, Tuple[int, int]]:
    """Batch id -> (its submit's start, its result's end), for the batches
    that have both."""
    sub = {s["batch"]: s["start_ns"] for s in spans
           if s["name"] == "runner.submit"}
    res = {s["batch"]: s["end_ns"] for s in spans
           if s["name"] == "runner.result" and s["end_ns"] is not None}
    return {b: (sub[b], res[b]) for b in sub if b in res}


def untraced_batches(spans: Sequence[Dict], window_ns: Sequence[int],
                     traced_ns: Optional[Sequence[int]]) -> Set[int]:
    """Batches wholly inside the window that the traced stretch (if any)
    does not touch."""
    out = set()
    for b, (s, e) in batch_extents(spans).items():
        if s < window_ns[0] or e > window_ns[1]:
            continue
        if traced_ns is not None and s <= traced_ns[1] and e >= traced_ns[0]:
            continue
        out.add(b)
    return out


def _ancestors(spans: Sequence[Dict], i: int):
    while i >= 0:
        yield i
        i = spans[i]["parent"]


def _inputs(ctx):
    sp, tr = ctx.get("spans"), ctx.get("trace")
    if not sp or not sp["spans"] or not tr or not tr.get("events"):
        return None
    return sp["spans"], tr["events"], tr["traced_ns"]


def host_ms(ctx, name: str) -> Optional[float]:
    """Median host ms of the spans ``name`` of the untraced batches."""
    sp = ctx.get("spans")
    if not sp or not sp["spans"]:
        return None
    spans = sp["spans"]
    tr = ctx.get("trace") or {}
    keep = untraced_batches(spans, sp["window_ns"], tr.get("traced_ns"))
    ms = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in spans
          if s["name"] == name and s["batch"] in keep]
    return statistics.median(ms) if ms else None


def kernel_ms(ctx, name: str) -> Optional[float]:
    """Device ms a whole traced batch of the ops launched inside spans
    ``name`` (and the spans under them)."""
    got = _inputs(ctx)
    if got is None:
        return None
    spans, events, traced = got
    whole = whole_batches(spans, *traced)
    if not whole:
        return None
    total = 0
    for o, i in zip(events["ops"], attribute(spans, events)):
        if i >= 0 and spans[i]["batch"] in whole and any(
                spans[a]["name"] == name for a in _ancestors(spans, i)):
            total += o[2] - o[1]
    return total * 1e-6 / len(whole)


def launch_calls(ctx) -> Optional[float]:
    """Launch, copy and set calls (those with a device op) a whole traced
    batch."""
    got = _inputs(ctx)
    if got is None:
        return None
    spans, events, traced = got
    whole = whole_batches(spans, *traced)
    if not whole:
        return None
    n = sum(1 for i in attribute(spans, events)
            if i >= 0 and spans[i]["batch"] in whole)
    return n / len(whole)


def breakdown(ctx) -> Optional[Dict]:
    """Device ms a whole traced batch by innermost span, and by span and
    kernel; the share of all traced device time put down to a span."""
    got = _inputs(ctx)
    if got is None:
        return None
    spans, events, traced = got
    whole = whole_batches(spans, *traced)
    by_span: Dict[str, float] = {}
    by_kernel: Dict[str, float] = {}
    total = named = 0
    for o, i in zip(events["ops"], attribute(spans, events)):
        d = o[2] - o[1]
        total += d
        if i < 0:
            continue
        named += d
        if spans[i]["batch"] not in whole:
            continue
        key = spans[i]["name"]
        by_span[key] = by_span.get(key, 0.0) + d * 1e-6 / len(whole)
        kk = f"{key} {devtrace.short_name(o[0])}"
        by_kernel[kk] = by_kernel.get(kk, 0.0) + d * 1e-6 / len(whole)
    return {"batches": len(whole), "by_span": by_span,
            "by_span_kernel": by_kernel,
            "attributed_share": named / total if total else None}


def idle_gaps(ctx, top: int = 10) -> Optional[List[List]]:
    """The longest gaps in the union of device op intervals, in seconds,
    each named by what the host was doing when it began (the innermost
    span open then, or ``(outside)``) and the op it follows."""
    got = _inputs(ctx)
    if got is None:
        return None
    spans, events, _ = got
    gaps, cur_e, last = [], None, None
    for name, s, e, _ in events["ops"]:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s - cur_e, last))
        if cur_e is None or e > cur_e:
            cur_e, last = e, name
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    found = innermost(spans, [g[0] for g in gaps])
    return [[f"{spans[i]['name'] if i >= 0 else OUTSIDE} after "
             f"{devtrace.short_name(k)}", d * 1e-9]
            for (t, d, k), i in zip(gaps, found)]
