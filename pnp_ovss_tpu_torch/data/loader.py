"""Threaded prefetching batch loader (the port's copy of
``pnp_ovss_tpu/data/loader.py``).

The reference feeds batches through torch's DataLoader with worker
processes (Load_datasets.py:20-27). Host-side image decode + resize is the
only real work, so a thread pool (PIL releases the GIL in its C codecs)
with double-buffered batch prefetch keeps the card fed: while batch N runs
on the device, batch N+1 decodes on the host. Batches are host numpy only;
the caller moves them to the card on its main thread.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from pnp_ovss_tpu_torch.data import transforms
from pnp_ovss_tpu_torch.data.datasets import ImageRecord


@dataclasses.dataclass
class LoadedBatch:
    records: List[ImageRecord]
    images: np.ndarray  # [B, S, S, 3] uint8 (normalised on the device)
    rgb_bucket: np.ndarray  # [B, Hb, Wb, 3] float32 0-255
    raw_images: List[np.ndarray]  # original-resolution RGB (parity CRF)
    gts: List[np.ndarray]  # ground-truth label maps
    gt_bucket: Optional[np.ndarray] = None  # [B, Hb, Wb] int32 (device eval)


class PrefetchLoader:
    def __init__(
        self,
        records: Sequence[ImageRecord],
        *,
        batch_size: int,
        img_size: int,
        bucket: int,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        load_gt: bool = True,
        keep_raw: bool = False,
        gt_at_bucket: bool = False,
    ):
        self.records = list(records)
        self.batch_size = batch_size
        self.img_size = img_size
        self.bucket = bucket
        self.num_workers = num_workers
        self.prefetch = prefetch_batches
        self.load_gt = load_gt
        self.keep_raw = keep_raw
        self.gt_at_bucket = gt_at_bucket

    def __len__(self):
        return -(-len(self.records) // self.batch_size)

    def _load_one(self, rec: ImageRecord):
        from PIL import Image

        raw = transforms.load_rgb(rec.image_path)
        # uint8: CLIP normalisation happens on device (runner._normalize).
        img = transforms.resize_for_model(raw, self.img_size)
        rgb = transforms.resize_rgb(raw, (self.bucket, self.bucket))
        gt = rec.load_gt() if self.load_gt else None
        gtb = None
        if gt is not None and self.gt_at_bucket:
            gtb = np.asarray(
                Image.fromarray(gt.astype(np.int32), mode="I").resize(
                    (self.bucket, self.bucket), Image.NEAREST
                ),
                np.int32,
            )
        return img, rgb, raw if self.keep_raw else None, gt, gtb

    def __iter__(self) -> Iterator[LoadedBatch]:
        batches = [
            self.records[i : i + self.batch_size]
            for i in range(0, len(self.records), self.batch_size)
        ]
        if not batches:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                for batch in batches:
                    if stop.is_set():
                        break
                    items = list(pool.map(self._load_one, batch))
                    imgs = np.stack([it[0] for it in items])
                    rgbs = np.stack([it[1] for it in items]).astype(
                        np.float32
                    )
                    gtb = None
                    if self.gt_at_bucket and items[0][4] is not None:
                        gtb = np.stack([it[4] for it in items])
                    out_q.put(LoadedBatch(
                        records=list(batch),
                        images=imgs,
                        rgb_bucket=rgbs,
                        raw_images=[it[2] for it in items],
                        gts=[it[3] for it in items],
                        gt_bucket=gtb,
                    ))
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
