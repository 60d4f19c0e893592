"""Dataset adapters: VOC / Pascal-Context / ADE20K / COCO object & stuff
(the port's copy of ``pnp_ovss_tpu/data/datasets.py``).

One lightweight host-side adapter per dataset (replacing the reference's
five ~400-LoC torch Dataset classes + DataLoader + DistributedSampler,
Dataset.py / Load_datasets.py) with the reference's exact semantics:

- VOC: val.txt split; GT PNG with 255 (ignore) remapped to 0
  (script Load_GroundTruth :903-908)
- PSC: ids from trainval_merged.json where phase == "val"
  (Dataset.py:604-609); GT from SegmentationClassContext, used raw
- ADE20K: file list from an .odgt manifest (Dataset.py:1148-1161); GT PNG
  used raw (0 = background); GPT key "ADE_val_%08d", numeric id with zeros
  stripped (Dataset.py:1270)
- COCO object/stuff: image list + GT rasterised from instance/stuff
  annotation JSONs via data/rle.py (replacing pycocotools); the stuff GT
  remap (label 255 -> 0, ids kept) is vectorised, replacing the reference's
  per-pixel Python loop (coco script :1117-1122).

Adapters are plain iterables of ImageRecord; sharding for data-parallel
hosts is a strided slice (rank::world) like DistributedSampler's
non-shuffled layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
from PIL import Image


@dataclasses.dataclass
class ImageRecord:
    img_id: str  # dataset image id (reference formats)
    gpt_key: str  # key into the GPT4o classification JSON
    image_path: str
    load_gt: Callable[[], np.ndarray]  # () -> [H, W] float32 label map


def _png_gt_loader(path: str, remap_255_to_0: bool) -> Callable[[], np.ndarray]:
    def load() -> np.ndarray:
        mask = np.asarray(Image.open(path), np.float32)
        if remap_255_to_0:
            mask = np.where(mask == 255, 0.0, mask)
        return mask

    return load


class VOCDataset:
    """PASCAL VOC 2012 val split (Dataset.py:349-445)."""

    def __init__(self, root: str, split: str = "val"):
        self.root = root
        split_file = os.path.join(
            root, "VOCdevkit/VOC2012/ImageSets/Segmentation", split + ".txt"
        )
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.ids)

    def records(self) -> Iterator[ImageRecord]:
        base = os.path.join(self.root, "VOCdevkit/VOC2012")
        for img_id in self.ids:
            yield ImageRecord(
                img_id=img_id,
                gpt_key=img_id,
                image_path=os.path.join(base, "JPEGImages", img_id + ".jpg"),
                load_gt=_png_gt_loader(
                    os.path.join(base, "SegmentationClass", img_id + ".png"),
                    remap_255_to_0=True,
                ),
            )


class PascalContextDataset:
    """Pascal Context val split (Dataset.py:570-1005)."""

    def __init__(self, root: str, split: str = "val"):
        self.root = root
        merged = os.path.join(root, "trainval_merged.json")
        with open(merged) as f:
            data = json.load(f)
        self.ids = [
            str(item["image_id"])
            for item in data["images"]
            if item["phase"] == split
        ]

    def __len__(self):
        return len(self.ids)

    def records(self) -> Iterator[ImageRecord]:
        for raw_id in self.ids:
            img_id = f"{raw_id[:4]}_{raw_id[4:]}"  # 2008001997 -> 2008_001997
            yield ImageRecord(
                img_id=img_id,
                gpt_key=img_id,
                image_path=os.path.join(
                    self.root, "VOCdevkit/VOC2012/JPEGImages", img_id + ".jpg"
                ),
                load_gt=_png_gt_loader(
                    os.path.join(
                        self.root,
                        "mmsegmentation/data/VOCdevkit/VOC2010/"
                        "SegmentationClassContext",
                        img_id + ".png",
                    ),
                    remap_255_to_0=False,
                ),
            )


class ADE20KDataset:
    """ADE20K validation via .odgt manifest (Dataset.py:1132-1298)."""

    def __init__(self, root: str, odgt_path: str):
        self.root = root
        self.items: List[Dict] = []
        with open(odgt_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.items.append(json.loads(line))

    def __len__(self):
        return len(self.items)

    def records(self) -> Iterator[ImageRecord]:
        for item in self.items:
            name = os.path.basename(item["fpath_img"])  # ADE_val_00000001.jpg
            stem = os.path.splitext(name)[0]
            numeric = stem.replace("ADE_val_", "").lstrip("0") or "0"
            yield ImageRecord(
                img_id=numeric,  # zeros stripped (Dataset.py:1270)
                gpt_key=stem,  # "ADE_val_00000001"
                image_path=os.path.join(
                    self.root, "ADEChallengeData2016/images/validation", name
                ),
                load_gt=_png_gt_loader(
                    os.path.join(
                        self.root,
                        "ADEChallengeData2016/annotations/validation",
                        stem + ".png",
                    ),
                    remap_255_to_0=False,
                ),
            )


class CocoDataset:
    """COCO val2017 with GT rasterised from annotation JSON (no pycocotools).

    For coco_object the GT uses thing annotations only; for coco_stuff the
    stuff annotations are layered on top (reference coco script
    :1095-1125). Overlapping annotations: later anns overwrite earlier
    ones, matching the reference's sequential mask writes.
    """

    def __init__(self, root: str, ann_file: str, *, stuff_ann_file: Optional[str] = None,
                 image_dir: str = "val2017", limit: Optional[int] = None):
        self.root = root
        self.image_dir = image_dir
        with open(os.path.join(root, ann_file)) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data["images"]}
        self.anns_by_img: Dict[int, List[Dict]] = {}
        for ann in data["annotations"]:
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        if stuff_ann_file:
            with open(os.path.join(root, stuff_ann_file)) as f:
                stuff = json.load(f)
            for ann in stuff["annotations"]:
                self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.images.keys())
        if limit:
            self.ids = self.ids[:limit]

    def __len__(self):
        return len(self.ids)

    def _gt_loader(self, img_id: int) -> Callable[[], np.ndarray]:
        from pnp_ovss_tpu_torch.data.rle import ann_to_mask

        def load() -> np.ndarray:
            info = self.images[img_id]
            h, w = info["height"], info["width"]
            gt = np.zeros((h, w), np.float32)
            for ann in self.anns_by_img.get(img_id, []):
                m = ann_to_mask(ann, h, w)
                cat = float(ann["category_id"])
                gt = np.where(m > 0, cat, gt)
            return gt

        return load

    def records(self) -> Iterator[ImageRecord]:
        for img_id in self.ids:
            info = self.images[img_id]
            yield ImageRecord(
                img_id=str(img_id),
                gpt_key=str(img_id),
                image_path=os.path.join(
                    self.root, self.image_dir, info["file_name"]
                ),
                load_gt=self._gt_loader(img_id),
            )


def shard_records(
    records: List[ImageRecord], rank: int, world_size: int
) -> List[ImageRecord]:
    """Strided shard, DistributedSampler-style (non-shuffled)."""
    return records[rank::world_size]


def make_dataset(data_type: str, home_dir: str, **kwargs):
    if data_type == "voc":
        return VOCDataset(home_dir)
    if data_type == "psc":
        return PascalContextDataset(home_dir)
    if data_type == "ade20k":
        odgt = kwargs.get(
            "odgt_path",
            os.path.join(home_dir, "validation.odgt"),
        )
        return ADE20KDataset(home_dir, odgt)
    if data_type == "coco_object":
        return CocoDataset(
            home_dir, kwargs.get("ann_file", "annotations/instances_val2017.json"),
            limit=kwargs.get("limit"),
        )
    if data_type == "coco_stuff":
        return CocoDataset(
            home_dir,
            kwargs.get("ann_file", "annotations/instances_val2017.json"),
            stuff_ann_file=kwargs.get(
                "stuff_ann_file", "annotations/stuff_val2017.json"
            ),
            limit=kwargs.get("limit"),
        )
    raise ValueError(f"unknown data_type {data_type!r}")
