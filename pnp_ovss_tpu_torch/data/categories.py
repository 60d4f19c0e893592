"""Dataset category tables and per-dataset metadata (the port's copy of
``pnp_ovss_tpu/data/categories.py``).

Canonical tables reproduced from the reference (Load_datasets.py:8-82 for
VOC/PSC/ADE20K; Calculate_mIoU.py:23-201 for the COCO object/stuff id->name
lists — standard public dataset taxonomies).

Caption names: every class must be a single whitespace token in the caption
so WordPiece '##' pooling can reassemble it (the reference strips spaces for
ADE20K — Load_datasets.py:85 — and its multi-word COCO names silently
misalign the pooling loop; we concatenate for all datasets and note the
divergence).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

VOC_CATS: Dict[int, str] = {
    1: "aeroplane", 2: "bicycle", 3: "bird", 4: "boat", 5: "bottle",
    6: "bus", 7: "car", 8: "cat", 9: "chair", 10: "cow", 11: "table",
    12: "dog", 13: "horse", 14: "motorbike", 15: "person",
    16: "pottedplant", 17: "sheep", 18: "sofa", 19: "train", 20: "tvmonitor",
}

PSC_CATS: Dict[int, str] = {
    1: "aeroplane", 2: "bag", 3: "bed", 4: "bedclothes", 5: "bench",
    6: "bicycle", 7: "bird", 8: "boat", 9: "book", 10: "bottle",
    11: "building", 12: "bus", 13: "cabinet", 14: "car", 15: "cat",
    16: "ceiling", 17: "chair", 18: "cloth", 19: "computer", 20: "cow",
    21: "cup", 22: "curtain", 23: "dog", 24: "door", 25: "fence",
    26: "floor", 27: "flower", 28: "food", 29: "grass", 30: "ground",
    31: "horse", 32: "keyboard", 33: "light", 34: "motorbike",
    35: "mountain", 36: "mouse", 37: "person", 38: "plate", 39: "platform",
    40: "pottedplant", 41: "road", 42: "rock", 43: "sheep", 44: "shelves",
    45: "sidewalk", 46: "sign", 47: "sky", 48: "snow", 49: "sofa",
    50: "table", 51: "track", 52: "train", 53: "tree", 54: "truck",
    55: "tvmonitor", 56: "wall", 57: "water", 58: "window", 59: "wood",
}

ADE20K_CATS: Dict[int, str] = {
    1: "wall", 2: "building", 3: "sky", 4: "floor", 5: "tree", 6: "ceiling",
    7: "road", 8: "bed", 9: "windowpane", 10: "grass", 11: "cabinet",
    12: "sidewalk", 13: "person", 14: "ground", 15: "door", 16: "table",
    17: "mountain", 18: "plant", 19: "curtain", 20: "chair", 21: "car",
    22: "water", 23: "painting", 24: "sofa", 25: "shelf", 26: "house",
    27: "sea", 28: "mirror", 29: "rug", 30: "field", 31: "armchair",
    32: "seat", 33: "fence", 34: "desk", 35: "rock", 36: "wardrobe",
    37: "lamp", 38: "bathtub", 39: "railing", 40: "cushion", 41: "base",
    42: "box", 43: "pillar", 44: "signboard", 45: "chest of drawers",
    46: "counter", 47: "sand", 48: "sink", 49: "skyscraper",
    50: "fireplace", 51: "refrigerator", 52: "grandstand", 53: "path",
    54: "stairs", 55: "runway", 56: "case", 57: "billiard table",
    58: "pillow", 59: "screen", 60: "stairway", 61: "river", 62: "bridge",
    63: "bookcase", 64: "blind", 65: "coffee table", 66: "toilet",
    67: "flower", 68: "book", 69: "hill", 70: "bench", 71: "countertop",
    72: "stove", 73: "palm", 74: "kitchen island", 75: "computer",
    76: "swivel chair", 77: "boat", 78: "bar", 79: "arcade machine",
    80: "hovel", 81: "bus", 82: "towel", 83: "light", 84: "truck",
    85: "tower", 86: "chandelier", 87: "sunshade", 88: "streetlight",
    89: "booth", 90: "television receiver", 91: "airplane",
    92: "dirt track", 93: "apparel", 94: "pole", 95: "land",
    96: "bannister", 97: "escalator", 98: "ottoman", 99: "bottle",
    100: "buffet", 101: "poster", 102: "stage", 103: "van", 104: "ship",
    105: "fountain", 106: "conveyer belt", 107: "canopy", 108: "washer",
    109: "toy", 110: "swimming pool", 111: "stool", 112: "barrel",
    113: "basket", 114: "waterfall", 115: "tent", 116: "bag",
    117: "motorbike", 118: "cradle", 119: "oven", 120: "ball", 121: "food",
    122: "stair", 123: "tank", 124: "marque", 125: "microwave", 126: "pot",
    127: "animal", 128: "bicycle", 129: "lake", 130: "dishwasher",
    131: "screen", 132: "blanket", 133: "sculpture", 134: "hood",
    135: "sconce", 136: "vase", 137: "trafficlight", 138: "tray",
    139: "trash can", 140: "fan", 141: "pier", 142: "crt screen",
    143: "plate", 144: "monitor", 145: "bulletinboard", 146: "shower",
    147: "radiator", 148: "glass", 149: "clock", 150: "flag",
}

# COCO "thing" classes: (category id, name) — ids are non-contiguous.
COCO_OBJECT_CATS: List = [
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"),
    (5, "airplane"), (6, "bus"), (7, "train"), (8, "truck"), (9, "boat"),
    (10, "traffic light"), (11, "fire hydrant"), (13, "stop sign"),
    (14, "parking meter"), (15, "bench"), (16, "bird"), (17, "cat"),
    (18, "dog"), (19, "horse"), (20, "sheep"), (21, "cow"),
    (22, "elephant"), (23, "bear"), (24, "zebra"), (25, "giraffe"),
    (27, "backpack"), (28, "umbrella"), (31, "handbag"), (32, "tie"),
    (33, "suitcase"), (34, "frisbee"), (35, "skis"), (36, "snowboard"),
    (37, "sports ball"), (38, "kite"), (39, "baseball bat"),
    (40, "baseball glove"), (41, "skateboard"), (42, "surfboard"),
    (43, "tennis racket"), (44, "bottle"), (46, "wine glass"), (47, "cup"),
    (48, "fork"), (49, "knife"), (50, "spoon"), (51, "bowl"),
    (52, "banana"), (53, "apple"), (54, "sandwich"), (55, "orange"),
    (56, "broccoli"), (57, "carrot"), (58, "hot dog"), (59, "pizza"),
    (60, "donut"), (61, "cake"), (62, "chair"), (63, "couch"),
    (64, "potted plant"), (65, "bed"), (67, "dining table"),
    (70, "toilet"), (72, "tv"), (73, "laptop"), (74, "mouse"),
    (75, "remote"), (76, "keyboard"), (77, "cell phone"),
    (78, "microwave"), (79, "oven"), (80, "toaster"), (81, "sink"),
    (82, "refrigerator"), (84, "book"), (85, "clock"), (86, "vase"),
    (87, "scissors"), (88, "teddy bear"), (89, "hair drier"),
    (90, "toothbrush"),
]

# COCO "stuff" classes appended after the things (ids 92-182).
COCO_STUFF_EXTRA: List = [
    (92, "banner"), (93, "blanket"), (94, "branch"), (95, "bridge"),
    (96, "building-other"), (97, "bush"), (98, "cabinet"), (99, "cage"),
    (100, "cardboard"), (101, "carpet"), (102, "ceiling-other"),
    (103, "ceiling-tile"), (104, "cloth"), (105, "clothes"),
    (106, "clouds"), (107, "counter"), (108, "cupboard"), (109, "curtain"),
    (110, "desk-stuff"), (111, "dirt"), (112, "door-stuff"),
    (113, "fence"), (114, "floor-marble"), (115, "floor-other"),
    (116, "floor-stone"), (117, "floor-tile"), (118, "floor-wood"),
    (119, "flower"), (120, "fog"), (121, "food-other"), (122, "fruit"),
    (123, "furniture-other"), (124, "grass"), (125, "gravel"),
    (126, "ground-other"), (127, "hill"), (128, "house"), (129, "leaves"),
    (130, "light"), (131, "mat"), (132, "metal"), (133, "mirror-stuff"),
    (134, "moss"), (135, "mountain"), (136, "mud"), (137, "napkin"),
    (138, "net"), (139, "paper"), (140, "pavement"), (141, "pillow"),
    (142, "plant-other"), (143, "plastic"), (144, "platform"),
    (145, "playingfield"), (146, "railing"), (147, "railroad"),
    (148, "river"), (149, "road"), (150, "rock"), (151, "roof"),
    (152, "rug"), (153, "salad"), (154, "sand"), (155, "sea"),
    (156, "shelf"), (157, "sky-other"), (158, "skyscraper"), (159, "snow"),
    (160, "solid-other"), (161, "stairs"), (162, "stone"), (163, "straw"),
    (164, "structural-other"), (165, "table"), (166, "tent"),
    (167, "textile-other"), (168, "towel"), (169, "tree"),
    (170, "vegetable"), (171, "wall-brick"), (172, "wall-concrete"),
    (173, "wall-other"), (174, "wall-panel"), (175, "wall-stone"),
    (176, "wall-tile"), (177, "wall-wood"), (178, "water-other"),
    (179, "waterdrops"), (180, "window-blind"), (181, "window-other"),
    (182, "wood"),
]

COCO_STUFF_CATS: List = COCO_OBJECT_CATS + COCO_STUFF_EXTRA


def caption_name(name: str) -> str:
    """Single-token caption form: drop spaces and hyphens
    (ADE rule Load_datasets.py:85; extended to COCO's multi-word names)."""
    return "".join("".join(name.split(" ")).split("-"))


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    data_type: str
    nms: List[str]  # caption class names, 0-indexed (GPT id - 1)
    category_ids: np.ndarray  # class index -> dataset category id
    id_to_name: Dict[int, str]  # dataset category id -> display name
    n_class: int  # confusion-matrix size (incl. background slot 0)

    def metric_class_names(self) -> List[str]:
        return [
            "Background" if i == 0 else self.id_to_name.get(i, f"class_{i}")
            for i in range(self.n_class)
        ]


def get_dataset_meta(data_type: str) -> DatasetMeta:
    if data_type == "voc":
        table = VOC_CATS
        pairs = sorted(table.items())
        n_class = 21
    elif data_type == "psc":
        table = PSC_CATS
        pairs = sorted(table.items())
        n_class = 60
    elif data_type == "ade20k":
        table = ADE20K_CATS
        pairs = sorted(table.items())
        n_class = 151
    elif data_type == "coco_object":
        pairs = COCO_OBJECT_CATS
        table = dict(pairs)
        n_class = 91  # ids are sparse; hist sized by max id + 1 (:569)
    elif data_type == "coco_stuff":
        pairs = COCO_STUFF_CATS
        table = dict(pairs)
        n_class = 183
    else:
        raise ValueError(f"unknown data_type {data_type!r}")
    return DatasetMeta(
        data_type=data_type,
        nms=[caption_name(n) for _, n in pairs],
        category_ids=np.asarray([i for i, _ in pairs], np.int32),
        id_to_name=table,
        n_class=n_class,
    )
