"""The port's host data and text modules against the JAX package's.

Fixtures rebuild those of ``tests/test_datasets.py``, ``tests/test_text.py``
and ``tests/test_rle_native.py``: the four dataset adapters, the COCO RLE
and polygon decoders, sharding, the category tables, the GPT class parser,
the image transforms and the prefetch loader must give equal results. The
port's RLE library is built into a temporary ``build/`` for this module and
held against the JAX package's numpy decoders.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from pnp_ovss_tpu.data import categories as jcat
from pnp_ovss_tpu.data import datasets as jds
from pnp_ovss_tpu.data import loader as jloader
from pnp_ovss_tpu.data import rle as jrle
from pnp_ovss_tpu.data import transforms as jtf
from pnp_ovss_tpu.text import labels as jlabels
from pnp_ovss_tpu_torch.data import categories as pcat
from pnp_ovss_tpu_torch.data import datasets as pds
from pnp_ovss_tpu_torch.data import loader as ploader
from pnp_ovss_tpu_torch.data import rle as prle
from pnp_ovss_tpu_torch.data import transforms as ptf
from pnp_ovss_tpu_torch.text import labels as plabels

DATA_TYPES = ("voc", "psc", "ade20k", "coco_object", "coco_stuff")


@pytest.fixture(scope="module", autouse=True)
def port_rle_build(tmp_path_factory):
    """The port's codec compiled into a temporary build directory. The
    JAX package decodes with its numpy functions here (its behaviour on a
    host without a compiler), so this module never runs its ``make`` in
    ``native/``."""
    mp = pytest.MonkeyPatch()
    build = tmp_path_factory.mktemp("build") / "rle"
    mp.setattr(prle, "BUILD_DIR", build)
    mp.setattr(jrle, "native_available", lambda: False)
    prle._lib.cache_clear()
    yield build
    prle._lib.cache_clear()
    mp.undo()


def encode_counts(counts):
    """COCO-API compressed RLE string encoder (``tests/test_rle_native.py``'s
    test-side inverse)."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            digit = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (digit & 0x10))
                        or (x == -1 and (digit & 0x10)))
            if more:
                digit |= 0x20
            out.append(chr(digit + 48))
    return "".join(out)


def mask_to_counts(mask):
    """[H, W] mask -> column-major run lengths starting with a 0-run."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.flatnonzero(np.diff(flat)) + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return [0] + counts if flat.size and flat[0] == 1 else counts


def _img(path, h=20, w=30, seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path)


def _mask(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def _voc(root):
    base = os.path.join(root, "VOCdevkit/VOC2012")
    os.makedirs(os.path.join(base, "ImageSets/Segmentation"))
    ids = [f"2007_00000{i}" for i in range(1, 4)]
    with open(os.path.join(base, "ImageSets/Segmentation/val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n\n")
    for i, img_id in enumerate(ids):
        _img(os.path.join(base, f"JPEGImages/{img_id}.jpg"), seed=i)
        m = np.zeros((20, 30), np.uint8)
        m[0, :5] = 255  # ignore pixels -> 0
        m[5:9, 5:9] = 12
        _mask(os.path.join(base, f"SegmentationClass/{img_id}.png"), m)


def _psc(root):
    with open(os.path.join(root, "trainval_merged.json"), "w") as f:
        json.dump({"images": [{"image_id": 2008001997, "phase": "val"},
                              {"image_id": 2008001998, "phase": "train"},
                              {"image_id": 2008002001, "phase": "val"}]}, f)
    for i, img_id in enumerate(("2008_001997", "2008_002001")):
        _img(os.path.join(root, f"VOCdevkit/VOC2012/JPEGImages/{img_id}.jpg"),
             seed=i)
        _mask(os.path.join(
            root, "mmsegmentation/data/VOCdevkit/VOC2010/"
            f"SegmentationClassContext/{img_id}.png"),
            np.full((20, 30), 7 + i, np.uint8))


def _ade(root):
    lines = []
    for i in (42, 100):
        name = f"ADE_val_{i:08d}"
        lines.append(json.dumps({
            "fpath_img": f"ADEChallengeData2016/images/validation/{name}.jpg",
            "fpath_segm": "unused"}))
        _img(os.path.join(
            root, f"ADEChallengeData2016/images/validation/{name}.jpg"))
        _mask(os.path.join(
            root, f"ADEChallengeData2016/annotations/validation/{name}.png"),
            np.full((20, 30), i % 150, np.uint8))
    with open(os.path.join(root, "validation.odgt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _coco(root):
    mask = np.zeros((20, 30), np.uint8)
    mask[3:11, 4:9] = 1
    things = {
        "images": [{"id": 7, "file_name": "000007.jpg", "height": 20,
                    "width": 30},
                   {"id": 3, "file_name": "000003.jpg", "height": 20,
                    "width": 30}],
        "annotations": [
            {"image_id": 7, "category_id": 18,  # polygon
             "segmentation": [[2.0, 2.0, 10.0, 2.0, 10.0, 8.0, 2.0, 8.0]]},
            {"image_id": 7, "category_id": 1,  # uncompressed RLE
             "segmentation": {"counts": [590, 10], "size": [20, 30]}},
            {"image_id": 3, "category_id": 44,  # compressed RLE
             "segmentation": {"counts": encode_counts(mask_to_counts(mask)),
                              "size": [20, 30]}},
        ],
    }
    stuff = {"annotations": [
        {"image_id": 3, "category_id": 124,
         "segmentation": [[15.0, 10.0, 29.0, 10.0, 29.0, 19.0, 15.0, 19.0]]},
    ]}
    os.makedirs(os.path.join(root, "annotations"))
    for name, data in (("instances_val2017.json", things),
                       ("stuff_val2017.json", stuff)):
        with open(os.path.join(root, "annotations", name), "w") as f:
            json.dump(data, f)
    for img_id in (7, 3):
        _img(os.path.join(root, f"val2017/{img_id:06d}.jpg"))


FIXTURES = {"voc": _voc, "psc": _psc, "ade20k": _ade, "coco_object": _coco,
            "coco_stuff": _coco}


@pytest.mark.parametrize("data_type", DATA_TYPES)
def test_dataset_adapters_equal_jax(tmp_path, data_type):
    FIXTURES[data_type](str(tmp_path))
    want = list(jds.make_dataset(data_type, str(tmp_path)).records())
    got = list(pds.make_dataset(data_type, str(tmp_path)).records())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.img_id, g.gpt_key, g.image_path) == \
            (w.img_id, w.gpt_key, w.image_path)
        gt_g, gt_w = g.load_gt(), w.load_gt()
        assert gt_g.dtype == gt_w.dtype == np.float32
        np.testing.assert_array_equal(gt_g, gt_w)
    assert any(r.load_gt().any() for r in got)


def test_native_codec_built_in_the_build_dir(port_rle_build):
    assert prle.native_available()
    assert [p.suffix for p in port_rle_build.iterdir()] == [".so"]
    assert not jrle.native_available()  # the JAX side: its numpy oracle


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compressed_rle_equal_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(5, 60), rng.randint(5, 60)
    mask = (rng.rand(h // 2 + 1, w // 2 + 1) > 0.5).astype(np.uint8)
    mask = np.kron(mask, np.ones((2, 2), np.uint8))[:h, :w]
    s = encode_counts(mask_to_counts(mask))
    got = prle.decode_compressed_rle(s, h, w)
    np.testing.assert_array_equal(got, mask)
    np.testing.assert_array_equal(got, jrle.decode_compressed_rle(s, h, w))
    np.testing.assert_array_equal(prle._decode_compressed_rle_py(s, h, w),
                                  mask)


@pytest.mark.parametrize("seed", list(range(4)))
def test_polygons_equal_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(8, 48), rng.randint(8, 48)
    polys = []
    for _ in range(rng.randint(1, 4)):
        n = rng.randint(3, 9)
        cx, cy = rng.rand(2) * [w, h]
        ang = np.sort(rng.rand(n)) * 2 * np.pi
        r = rng.rand(n) * max(h, w) * 0.5 + 1
        polys.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                              axis=1).reshape(-1).tolist())
    polys.append([2.0, 2.0, 10.0, 2.0, 10.0, 10.0, 2.0, 10.0, 99.0])  # odd
    got = prle.rasterize_polygon(polys, h, w)
    np.testing.assert_array_equal(got, jrle.rasterize_polygon(polys, h, w))
    np.testing.assert_array_equal(got, prle._rasterize_polygon_py(polys, h, w))


def test_counts_and_ann_dispatch_equal_jax():
    for mask in (np.zeros((7, 3), np.uint8), np.ones((7, 3), np.uint8),
                 np.eye(6, dtype=np.uint8)):
        counts = mask_to_counts(mask)
        for seg in ({"counts": counts}, {"counts": encode_counts(counts)}):
            got = prle.ann_to_mask({"segmentation": seg}, *mask.shape)
            np.testing.assert_array_equal(got, mask)
            np.testing.assert_array_equal(
                got, jrle.ann_to_mask({"segmentation": seg}, *mask.shape))
    with pytest.raises(ValueError):
        prle._counts_to_mask([5, 100], 3, 3)


def test_python_codec_without_a_compiler(monkeypatch):
    """A host without a compiler decodes with the numpy functions."""
    monkeypatch.setattr(prle, "native_available", lambda: False)
    mask = np.eye(6, dtype=np.uint8)
    s = encode_counts(mask_to_counts(mask))
    np.testing.assert_array_equal(prle.decode_compressed_rle(s, 6, 6), mask)
    poly = [[2, 3, 12, 3, 12, 9, 2, 9]]
    assert prle.rasterize_polygon(poly, 20, 30).sum() == 10 * 6


def test_shard_records_equal_jax():
    recs = list(range(11))
    for rank, world in ((0, 1), (0, 4), (3, 4), (2, 3)):
        assert pds.shard_records(recs, rank, world) == \
            jds.shard_records(recs, rank, world)


@pytest.mark.parametrize("data_type", DATA_TYPES)
def test_dataset_meta_equal_jax(data_type):
    got, want = pcat.get_dataset_meta(data_type), \
        jcat.get_dataset_meta(data_type)
    assert (got.nms, got.id_to_name, got.n_class) == \
        (want.nms, want.id_to_name, want.n_class)
    np.testing.assert_array_equal(got.category_ids, want.category_ids)
    assert got.metric_class_names() == want.metric_class_names()


GPT_CASES = [
    "[1: 'wall', 5: 'sky', 12: 'person'], [1: 90%, 5: 60%, 12: 80%]",
    "[2: 'cat']\n[2: 95%]",
    "[3: 'dog'], [3: 50%]",
    "",
    "no objects detected",
    "[4: 'boat',\n 9: 'x'],\n\n[4: 71%, 9: 99%]",
    "[40: 'far'], [40: 99%]",
    "[7: 'car', 7: 'car', x: 'bad'], [7: 88%, 7: 90%, x: 99%]",
]


@pytest.mark.parametrize("raw", GPT_CASES)
def test_parse_gpt_classes_equal_jax(raw):
    assert plabels.parse_gpt_classes(raw, 20) == \
        jlabels.parse_gpt_classes(raw, 20)


def test_label_provider_equal_jax(tmp_path):
    path = tmp_path / "gpt.json"
    path.write_text(json.dumps(dict(enumerate(GPT_CASES))))
    nms = pcat.get_dataset_meta("voc").nms
    got = plabels.GPTLabelProvider(str(path), nms, prob_cutoff=70)
    want = jlabels.GPTLabelProvider(str(path), nms, prob_cutoff=70)
    for key in map(str, range(len(GPT_CASES))):
        assert got.lookup(key) == want.lookup(key)


def test_transforms_equal_jax():
    rng = np.random.RandomState(0)
    img = (rng.rand(37, 53, 3) * 255).astype(np.uint8)
    for fn, args in (("preprocess_image", (48,)),
                     ("resize_for_model", (48,)),
                     ("normalized_01", (48,)),
                     ("resize_rgb", ((32, 40),))):
        got, want = getattr(ptf, fn)(img, *args), getattr(jtf, fn)(img, *args)
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)
    np.testing.assert_array_equal(ptf.CLIP_MEAN, jtf.CLIP_MEAN)
    np.testing.assert_array_equal(ptf.CLIP_STD, jtf.CLIP_STD)


def test_prefetch_loader_equal_jax(tmp_path):
    _voc(str(tmp_path))
    kw = dict(batch_size=2, img_size=48, bucket=32, num_workers=3,
              keep_raw=True, gt_at_bucket=True)
    recs = list(pds.make_dataset("voc", str(tmp_path)).records())
    jrecs = list(jds.make_dataset("voc", str(tmp_path)).records())
    got = list(ploader.PrefetchLoader(recs, **kw))
    want = list(jloader.PrefetchLoader(jrecs, **kw))
    assert [len(b.records) for b in got] == [2, 1]  # ragged tail
    assert len(got) == len(want) == len(ploader.PrefetchLoader(recs, **kw))
    for g, w in zip(got, want):
        assert [r.img_id for r in g.records] == [r.img_id for r in w.records]
        for field in ("images", "rgb_bucket", "gt_bucket"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        for a, b in zip(g.raw_images + g.gts, w.raw_images + w.gts):
            np.testing.assert_array_equal(a, b)
