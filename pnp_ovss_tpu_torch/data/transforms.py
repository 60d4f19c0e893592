"""Host-side image preprocessing (the port's copy of
``pnp_ovss_tpu/data/transforms.py``).

Matches the reference dataset transforms (Dataset.py:395-445):
- PIL bicubic resize to (img_size, img_size)
- ToTensor + CLIP normalisation, mean (0.48145466, 0.4578275, 0.40821073),
  std (0.26862954, 0.26130258, 0.27577711)

Images stay NHWC (the reference uses NCHW). The runner uploads uint8 and
applies the CLIP normalisation on the device (pipeline/runner.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8 (reference load_OrgImage, script :929-955)."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def preprocess_image(
    img: "Image.Image | np.ndarray", img_size: int
) -> np.ndarray:
    """PIL bicubic resize + CLIP normalise -> [S, S, 3] float32 NHWC."""
    x = resize_for_model(img, img_size).astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def resize_for_model(
    img: "Image.Image | np.ndarray", img_size: int
) -> np.ndarray:
    """PIL bicubic resize only -> [S, S, 3] uint8. The CLIP normalisation
    of the uint8 result on the device equals ``preprocess_image``."""
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img = img.convert("RGB").resize((img_size, img_size), Image.BICUBIC)
    return np.asarray(img, np.uint8)


def resize_rgb(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear uint8 RGB resize to (H, W) — CRF guidance image."""
    h, w = size
    pil = Image.fromarray(img.astype(np.uint8)).resize((w, h), Image.BILINEAR)
    return np.asarray(pil)


def normalized_01(img: "Image.Image | np.ndarray", img_size: int) -> np.ndarray:
    """The reference's ``norm_img`` (plain resize / 255, Dataset.py:433-434)."""
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img = img.convert("RGB").resize((img_size, img_size))
    return np.asarray(img, np.float32) / 255.0
