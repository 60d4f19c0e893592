"""Tracing / profiling (the port's counterpart of
``pnp_ovss_tpu/utils/tracing.py``; the reference uses ad-hoc
time.perf_counter prints and CUDA max-mem in MetricLogger):

- ``Tracer.stage(name)``: a wall-clock timer inside a
  ``torch.profiler.record_function`` range, so stages show up in profiler
  traces, accumulated per stage with summary export;
- ``profile_to(dir)``: a ``torch.profiler`` trace of the enclosed region,
  written as a Chrome trace;
- ``device_memory_stats()``: the CUDA caching allocator's statistics
  (empty on the CPU).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class Tracer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / self.counts[name], 4),
            }
            for name in self.totals
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[None]:
    """Trace the enclosed region (CPU, and CUDA where a card is present)
    into ``{log_dir}/trace.json`` (Chrome trace format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device: Optional[torch.device] = None) -> Dict:
    """Memory statistics of a CUDA device (the current one by default);
    empty for a CPU device or without a card."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
