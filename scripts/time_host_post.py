"""Time the host parity path's separable products two ways on this host's
CPU: the JAX package's formulation (two float32 ``np.einsum`` calls, copied
here, not imported) against the port's (``ops/host_post.py``: two float64
BLAS ``np.matmul`` calls rounded to float32 once).

    python scripts/time_host_post.py [--reps 5] [--threads 4]

Both run on the same inputs, in turns (einsum, matmul, matmul, einsum, ...)
so that drift on a shared host falls on both alike:

- one bilinear resize, grid 21 -> 375 x 500 (a VOC image), [C, 21, 21];
- one blur (sigma 1, truncate 4) at 375 x 500, [C, 375, 500];
- ``--images`` blurs spread over a thread pool of ``--threads`` workers, as
  the CLI's finalize worker spreads a batch's parity images.

C = 4 channels (3 classes and the background). Prints one JSON line with
the median seconds of each, the largest difference between the two
formulations, the CPU count and the card's name and power limit from
``nvidia-smi`` (or "no card").
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pnp_ovss_tpu_torch.ops import host_post  # noqa: E402
from pnp_ovss_tpu_torch.ops.blur import _blur_matrix_np  # noqa: E402
from pnp_ovss_tpu_torch.ops.resize import _interp_matrix_np  # noqa: E402


def einsum_separable(ah: np.ndarray, aw: np.ndarray,
                     x: np.ndarray) -> np.ndarray:
    """The JAX package's products (pnp_ovss_tpu/ops/host_post.py:38-39,
    :60-61): float32 einsum over the rows, then over the columns."""
    y = np.einsum("oh,...hw->...ow", ah, x.astype(np.float32))
    return np.einsum("pw,...ow->...op", aw, y)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "no card"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no card"


def timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--images", type=int, default=8)
    args = p.parse_args(argv)

    h, w, g, c = 375, 500, 21, 4
    rng = np.random.RandomState(0)
    grid = rng.rand(c, g, g).astype(np.float32)
    full = rng.rand(c, h, w).astype(np.float32)
    rh, rw = _interp_matrix_np(g, h), _interp_matrix_np(g, w)
    bh, bw = _blur_matrix_np(h, 1.0, 4.0), _blur_matrix_np(w, 1.0, 4.0)
    cases = {
        "resize_21_to_375x500": ((rh, rw, grid),),
        "blur_375x500": ((bh, bw, full),),
    }
    forms = {"einsum_f32": einsum_separable,
             "matmul_f64": host_post._separable}
    out = {"card": card_line(), "cpus": os.cpu_count(), "channels": c,
           "reps": args.reps}
    for name, (inputs,) in cases.items():
        times = {f: [] for f in forms}
        order = list(forms)
        for rep in range(args.reps):
            for f in (order if rep % 2 == 0 else order[::-1]):
                times[f].append(timed(forms[f], *inputs))
        diff = float(np.abs(forms["einsum_f32"](*inputs)
                            - forms["matmul_f64"](*inputs)).max())
        out[name] = {f: statistics.median(t) for f, t in times.items()}
        out[name]["max_abs_diff"] = diff

    def pool_run(form):
        fn = forms[form]
        with ThreadPoolExecutor(args.threads) as pool:
            list(pool.map(lambda _: fn(bh, bw, full), range(args.images)))

    times = {f: [] for f in forms}
    for rep in range(args.reps):
        for f in (list(forms) if rep % 2 == 0 else list(forms)[::-1]):
            times[f].append(timed(pool_run, f))
    out[f"blur_x{args.images}_on_{args.threads}_threads"] = {
        f: statistics.median(t) for f, t in times.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
