"""Structured run logging (the port's counterpart of
``pnp_ovss_tpu/utils/logging.py``, which replaces the reference's
utils.py MetricLogger/SmoothedValue).

Reference: utils.py:30-179 — windowed smoothed timings, ETA printing;
print-gating for distributed ranks (utils.py:210-222, which the reference
defines but never calls — here rank gating is on by default). Ranks come
from ``torch.distributed``: rank 0 of a world of 1 when no process group
is initialised.
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Iterable, Iterator, Optional

import torch
import torch.distributed as dist


def _dist_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _dist_active() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _dist_active() else 1


class SmoothedValue:
    """Track a series with a sliding window (reference utils.py:30-89)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """All-reduce count/total across ranks (reference utils.py:48-59:
        dist.barrier + all_reduce on [count, total]); the smoothing window
        (median/avg) stays rank-local, as in the reference. The tensor
        lives on the card under NCCL and on the CPU under gloo."""
        if get_world_size() == 1:
            return
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([float(self.count), self.total],
                         dtype=torch.float64, device=device)
        dist.barrier()
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg
        )


def is_main_process() -> bool:
    return get_rank() == 0


def log(msg: str, *, all_ranks: bool = False):
    if all_ranks or is_main_process():
        print(msg, flush=True)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self):
        """Sync every meter's global stats across ranks (reference
        utils.py:122-124). After this, global_avg is identical on all
        ranks — one host's log tells the whole run's story."""
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(
        self, iterable: Iterable, print_freq: int,
        header: str = "", total: Optional[int] = None,
    ) -> Iterator:
        total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None
        )
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and is_main_process():
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i))
                    )
                    log(
                        f"{header} [{i}/{total}] eta: {eta} {self} "
                        f"time: {iter_time}"
                    )
                else:
                    log(f"{header} [{i}] {self} time: {iter_time}")
            end = time.time()
        elapsed = time.time() - start
        log(f"{header} done in {datetime.timedelta(seconds=int(elapsed))}")
