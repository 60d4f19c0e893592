"""COCO mask decoding without pycocotools (the port's copy of
``pnp_ovss_tpu/data/rle.py``).

The reference depends on pycocotools for ``annToMask`` (coco script
:1095-1125). This module implements the needed subset twice, as the JAX
package does:

- the C++ core ``native/rle/rle.cc``, which the port compiles itself with
  ``g++ -O2 -shared -fPIC`` into ``build/rle/`` at the repository root at
  first use (the library's name carries a hash of the source, so an edited
  source is rebuilt) and loads with ctypes; ``native/`` is only read;
- the pure-numpy ``*_py`` functions, used on a host without a compiler and
  as the oracle the native path is tested against.

Formats: compressed RLE strings (the LEB128-style ASCII format of the COCO
API), uncompressed RLE counts lists, and polygon rasterisation (even-odd
scanline fill at pixel centers, COCO's frPoly convention).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "rle" / "rle.cc"
BUILD_DIR = _REPO / "build" / "rle"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    """The native codec, built on first use; None where it cannot be built
    or loaded (the ``*_py`` functions then serve every call)."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"librle-{h.hexdigest()[:16]}.so"
    try:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.rle_decode_string.argtypes = [ctypes.c_char_p, i64, i64, u8p]
    lib.rle_decode_counts.argtypes = [i64p, i64, i64, i64, u8p]
    lib.rle_rasterize_polygons.argtypes = [f64p, i64p, i64, i64, i64, u8p]
    for f in (lib.rle_decode_string, lib.rle_decode_counts,
              lib.rle_rasterize_polygons):
        f.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    return _lib() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_compressed_rle(
    rle_str: Union[str, bytes], h: int, w: int
) -> np.ndarray:
    """COCO compressed RLE string -> [H, W] uint8 mask."""
    if native_available():
        out = np.empty((h, w), np.uint8)
        s = rle_str if isinstance(rle_str, bytes) else rle_str.encode("ascii")
        rc = _lib().rle_decode_string(s, h, w, _u8p(out))
        if rc == 0:
            return out
        raise ValueError("malformed compressed RLE string")
    return _decode_compressed_rle_py(rle_str, h, w)


def _decode_compressed_rle_py(
    rle_str: Union[str, bytes], h: int, w: int
) -> np.ndarray:
    if isinstance(rle_str, bytes):
        rle_str = rle_str.decode("ascii")
    counts: List[int] = []
    i = 0
    n = len(rle_str)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(rle_str[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return _counts_to_mask_py(counts, h, w)


def _counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Uncompressed column-major counts -> [H, W] uint8 mask."""
    if native_available():
        c = np.ascontiguousarray(counts, np.int64)
        out = np.empty((h, w), np.uint8)
        rc = _lib().rle_decode_counts(
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(c), h, w, _u8p(out),
        )
        if rc == 0:
            return out
        raise ValueError("RLE counts overflow the image area")
    return _counts_to_mask_py(counts, h, w)


def _counts_to_mask_py(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # column-major


def rasterize_polygon(
    polys: Sequence[Sequence[float]], h: int, w: int
) -> np.ndarray:
    """COCO polygon list [[x0,y0,x1,y1,...], ...] -> [H, W] uint8 mask.

    Even-odd scanline fill at pixel centers (x+0.5, y+0.5 convention of the
    COCO API's frPoly path).
    """
    if native_available():
        sizes = np.asarray([len(p) // 2 for p in polys], np.int64)
        xy = np.concatenate(
            [np.asarray(p[: 2 * n], np.float64) for p, n in zip(polys, sizes)]
        ) if len(polys) else np.zeros(0, np.float64)
        xy = np.ascontiguousarray(xy)
        out = np.empty((h, w), np.uint8)
        _lib().rle_rasterize_polygons(
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(sizes), h, w, _u8p(out),
        )
        return out
    return _rasterize_polygon_py(polys, h, w)


def _rasterize_polygon_py(
    polys: Sequence[Sequence[float]], h: int, w: int
) -> np.ndarray:
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        # Truncate a dangling odd coordinate exactly like the native path
        # (len // 2 vertex pairs), so both rasterisers agree on it.
        poly = poly[: 2 * (len(poly) // 2)]
        xs = np.asarray(poly[0::2], np.float64)
        ys = np.asarray(poly[1::2], np.float64)
        if len(xs) < 3:
            continue
        # For each row (pixel center y+0.5) find crossing x's.
        for y in range(h):
            cy = y + 0.5
            x0s, y0s = xs, ys
            x1s = np.roll(xs, -1)
            y1s = np.roll(ys, -1)
            cond = (y0s <= cy) != (y1s <= cy)
            if not cond.any():
                continue
            t = (cy - y0s[cond]) / (y1s[cond] - y0s[cond])
            cross = x0s[cond] + t * (x1s[cond] - x0s[cond])
            cross.sort()
            for a, b in zip(cross[0::2], cross[1::2]):
                # Clamp BEFORE slicing: a span entirely left of the canvas
                # has hi + 1 < 0, and a negative slice stop would wrap
                # around and paint nearly the whole row.
                lo = max(int(np.ceil(a - 0.5)), 0)
                hi = min(int(np.floor(b - 0.5)), w - 1)
                if hi >= lo:
                    mask[y, lo : hi + 1] ^= 1
    return mask


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """COCO annotation dict -> [H, W] uint8 mask (pycocotools.annToMask)."""
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return rasterize_polygon(seg, h, w)
    counts = seg["counts"]
    if isinstance(counts, list):
        return _counts_to_mask(counts, h, w)
    return decode_compressed_rle(counts, h, w)
