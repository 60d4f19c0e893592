"""Reduction of a device trace (``torch.profiler``, CUDA activity only) to
what the per-layer readers take: each kernel's name and interval, the
device's busy time (the union of kernel intervals), device time by
kernel, and the longest idle gaps, each named by the kernel it follows.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

Kernel = Tuple[str, float, float]  # name, start us, end us


def kernels_of(prof) -> List[Kernel]:
    """The traced kernels (and device copies and sets), by start."""
    import torch

    out = [(e.name, float(e.time_range.start), float(e.time_range.end))
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(out, key=lambda k: k[1])


def busy_us(kernels: List[Kernel]) -> float:
    """Length of the union of the kernels' intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, its arguments and the
    anonymous namespace, at most 80 characters."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80] or "(unnamed)"


def by_name(kernels: List[Kernel]) -> Dict[str, float]:
    """Device seconds by short kernel name."""
    out: Dict[str, float] = {}
    for name, s, e in kernels:
        key = short_name(name)
        out[key] = out.get(key, 0.0) + (e - s) * 1e-6
    return out


def idle_gaps(kernels: List[Kernel], top: int = 10) -> List[List]:
    """The longest gaps in the union of kernel intervals, in seconds,
    each named by the kernel that ends before it."""
    gaps, cur_e, last = [], None, None
    for name, s, e in kernels:
        if cur_e is not None and s > cur_e:
            gaps.append([f"after {short_name(last)}", (s - cur_e) * 1e-6])
        if cur_e is None or e > cur_e:
            cur_e, last = e, name
    return sorted(gaps, key=lambda g: -g[1])[:top]


def matching(kernels: List[Kernel], pattern: str) -> List[Kernel]:
    """Kernels whose name matches the regular expression ``pattern``."""
    rx = re.compile(pattern)
    return [k for k in kernels if rx.search(k[0])]
