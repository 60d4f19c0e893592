"""ctypes binding of the native permutohedral DenseCRF for the host parity
path (the port's counterpart of ``pnp_ovss_tpu/ops/crf_host.py``).

``native/densecrf/permutohedral.cc`` (the lattice of Adams, Baek and Davis
and the Krahenbuhl-Koltun mean-field update) stands in for the reference's
pydensecrf call (reference script :1030-1074):

- ``permutohedral_filter``: K @ values with K = exp(-||f_i - f_j||^2 / 2),
  by the lattice approximation;
- ``densecrf_labels``: mean-field inference at ground-truth resolution.

The port compiles the source itself with ``g++`` and portable flags (no
``-march=native``) into ``build/densecrf/`` at the repository root, under
a name keyed by a hash of the source and the flags, and never runs
``make`` in ``native/``, whose ``libdensecrf.so`` belongs to the JAX
package. Each building process writes its own temporary file and renames
it into place, so processes that build at once (pytest workers) all load
a whole library. Without a compiler ``densecrf_labels`` raises; ``available``
says whether the library builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from pnp_ovss_tpu_torch.config import CRFConfig

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "densecrf" / "permutohedral.cc"
BUILD_DIR = _REPO / "build" / "densecrf"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_BUILD_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdensecrf-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The lattice library, built on first use. Raises
    ``subprocess.CalledProcessError`` or ``OSError`` (no compiler, a
    compile error) with the compiler's output."""
    so = library_path()
    with _BUILD_LOCK:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    check=True, capture_output=True, text=True)
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.permutohedral_filter.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, f32p]
    lib.permutohedral_filter.restype = None
    lib.densecrf_inference.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, i32p]
    lib.densecrf_inference.restype = None
    return lib


def available() -> bool:
    """Whether the lattice library builds and loads here."""
    try:
        _lib()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def permutohedral_filter(features: np.ndarray,
                         values: np.ndarray) -> np.ndarray:
    """features [N, d], values [N, c] -> f32 [N, c]: K @ values with
    K = exp(-||f_i - f_j||^2 / 2) (lattice approximation)."""
    n, d = features.shape
    c = values.shape[1]
    feats, vals = _f32(features), _f32(values)
    out = np.empty((n, c), np.float32)
    _lib().permutohedral_filter(_ptr(feats, ctypes.c_float), n, d,
                                _ptr(vals, ctypes.c_float), c,
                                _ptr(out, ctypes.c_float))
    return out


def densecrf_labels(logits: np.ndarray, image_rgb: np.ndarray,
                    cfg: CRFConfig) -> np.ndarray:
    """logits [C, H, W] mask maps, image_rgb [H, W, 3] 0-255 -> [H, W]
    int32 labels of mean-field inference at full resolution."""
    c, h, w = logits.shape
    unary = _f32(logits.reshape(c, h * w).T)  # [N, C]
    img = _f32(np.asarray(image_rgb).reshape(h * w, 3))
    out = np.empty(h * w, np.int32)
    _lib().densecrf_inference(
        _ptr(unary, ctypes.c_float), _ptr(img, ctypes.c_float),
        h, w, c, cfg.num_iters, cfg.pos_w, cfg.pos_xy_std, cfg.bi_w,
        cfg.bi_xy_std, cfg.bi_rgb_std, _ptr(out, ctypes.c_int32))
    return out.reshape(h, w)
