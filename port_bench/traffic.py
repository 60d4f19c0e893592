"""The one generator of traffic: a pool of host batches from a traffic
file's parameters and a seed.

A traffic file (``traffic/<name>.json``) gives:

- ``classes``: the names a caption may hold (single WordPiece words of
  the toy vocabulary, which is built from them);
- ``classes_per_image``: [lo, hi]. Every batch holds each count from lo
  to hi in equal shares, as near as its size allows, in an order drawn
  from the seed, so seeds and batches change the inputs and not the
  work; ``gt_size``: [h, w], every image's ground-truth size;
- ``objects_per_image``: [lo, hi] shapes over a photo-like background, so
  that the CRF's bilateral term meets edges;
- ``pool_batches``: distinct batches that the window cycles through;
- ``pipeline`` and ``precision``: settings laid over the configuration's
  (e.g. the CRF's subsample), ``check`` and ``trace``: what the
  comparison samples and what the traced run traces.

Images are drawn at their ground-truth size on the device, resized to
the model's input (bicubic) and to the CRF bucket (nearest), and kept on
the host as uint8, as the CLI's loader hands them over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

PREFIX_WORDS = ("a", "picture", "of")
SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


@dataclasses.dataclass
class Pool:
    images: np.ndarray  # [n, S, S, 3] uint8, the model's input
    rgb: np.ndarray  # [n, Hb, Wb, 3] uint8, the CRF bucket
    class_lists: List[List[str]]
    gt_sizes: List[Tuple[int, int]]
    batch: int

    def batch_slice(self, i: int) -> slice:
        """The i-th batch of a window: the pool's batches in turn."""
        j = i % (len(self.class_lists) // self.batch)
        return slice(j * self.batch, (j + 1) * self.batch)


def vocab(traffic: Dict) -> Dict[str, int]:
    """The toy WordPiece vocabulary: specials, single letters and their
    continuations, the caption's prefix and every class name's words,
    then [DEC] and [ENC]."""
    out: Dict[str, int] = {}
    for tok in SPECIALS:
        out[tok] = len(out)
    for ch in "abcdefghijklmnopqrstuvwxyz":
        out.setdefault(ch, len(out))
        out.setdefault("##" + ch, len(out))
    for name in list(PREFIX_WORDS) + list(traffic["classes"]):
        for word in name.lower().split():
            out.setdefault(word, len(out))
    out["[DEC]"] = len(out)
    out["[ENC]"] = len(out)
    return out


def class_counts(lo: int, hi: int, batch: int, batches: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Classes of each image: every batch holds lo..hi in turn, shuffled
    within the batch."""
    one = lo + np.arange(batch) % (hi - lo + 1)
    return np.concatenate([rng.permutation(one) for _ in range(batches)])


def photo_like(h: int, w: int, objects: int, gen: torch.Generator
               ) -> torch.Tensor:
    """[h, w, 3] float 0-255: smooth textured background, ``objects``
    ellipses of their own colour and texture, and noise."""
    dev = gen.device
    u = torch.rand(8 + 8 * objects, generator=gen, device=dev)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    f = 5 + 10 * u[:3]
    img = torch.stack([120 + 60 * torch.sin(xx / f[0] + 6 * u[3]),
                       100 + 50 * torch.cos(yy / f[1] + 6 * u[4]),
                       90 + 45 * torch.sin((xx + yy) / f[2])], -1)
    for k in range(objects):
        v = u[8 + 8 * k:16 + 8 * k]
        cy, cx = v[0] * h, v[1] * w
        ry, rx = (0.1 + 0.3 * v[2]) * h, (0.1 + 0.3 * v[3]) * w
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        colour = 255 * v[4:7]
        tex = 20 * torch.sin((xx + yy) / (3 + 6 * v[7]))
        img = torch.where(inside[..., None], colour + tex[..., None], img)
    noise = torch.randn((h, w, 3), generator=gen, device=dev)
    return (img + 12 * noise).clamp(0, 255)


def make_pool(traffic: Dict, *, batch: int, image_size: int, bucket: int,
              seed: int, device) -> Pool:
    n = traffic["pool_batches"] * batch
    rng = np.random.default_rng(int(seed))
    lo, hi = traffic["classes_per_image"]
    counts = class_counts(lo, hi, batch, traffic["pool_batches"], rng)
    names = list(traffic["classes"])
    class_lists = [[names[j] for j in rng.choice(len(names), int(c),
                                                 replace=False)]
                   for c in counts]
    gt_sizes = [tuple(int(x) for x in traffic["gt_size"])] * n
    lo, hi = traffic["objects_per_image"]
    n_objects = rng.integers(lo, hi + 1, size=n)

    gen = torch.Generator(device=device).manual_seed(int(seed))
    images = torch.empty((n, image_size, image_size, 3), dtype=torch.uint8,
                         device=device)
    rgb = torch.empty((n, bucket, bucket, 3), dtype=torch.uint8,
                      device=device)

    def u8(x):
        return x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)

    for i, (h, w) in enumerate(gt_sizes):
        img = photo_like(h, w, int(n_objects[i]), gen).permute(2, 0, 1)[None]
        images[i] = u8(F.interpolate(img, size=(image_size, image_size),
                                     mode="bicubic", antialias=True,
                                     align_corners=False))
        rgb[i] = u8(F.interpolate(img, size=(bucket, bucket),
                                  mode="nearest"))
    return Pool(images.cpu().numpy(), rgb.cpu().numpy(), class_lists,
                gt_sizes, batch)


def check_sample(traffic: Dict, seed: int, pool: Pool
                 ) -> Dict[int, List[int]]:
    """The window batches and images the comparison reads: {window batch
    index: [image indices]}, drawn from the seed. In each batch the
    image with the most classes, and others at random."""
    spec = traffic["check"]
    rng = np.random.default_rng(int(seed) + 1)
    batches = rng.choice(spec["within_first"], spec["batches"],
                         replace=False)
    out = {}
    for b in sorted(int(x) for x in batches):
        sl = pool.batch_slice(b)
        n_cls = [len(c) for c in pool.class_lists[sl]]
        most = int(np.argmax(n_cls))
        rest = [i for i in range(pool.batch) if i != most]
        extra = rng.choice(rest, spec["images_per_batch"] - 1, replace=False)
        out[b] = sorted([most] + [int(x) for x in extra])
    return out
