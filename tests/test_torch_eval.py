"""The port's evaluation against the JAX package's.

``fast_hist_t`` / ``batch_hist_t`` and ``SegmentationRunner.make_hist_fn``
on CPU tensors against ``fast_hist_jnp`` and the JAX runner's
``make_hist_fn`` on seeded labels (predictions past the class count and
out-of-range GT included): equal, as integers. ``scores_from_hist`` and the
offline aggregator against the JAX package's on the same hist files
(rtol 1e-12).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.evalx import aggregate as jagg
from pnp_ovss_tpu.evalx import metrics as jmetrics
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.pipeline.runner import SegmentationRunner as JaxRunner
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.data.categories import get_dataset_meta
from pnp_ovss_tpu_torch.evalx import aggregate as pagg
from pnp_ovss_tpu_torch.evalx import metrics as pmetrics
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.pipeline.runner import PendingBatch, SegmentationRunner

N_CLASS = 21


def _labels(seed, shape, n_class=N_CLASS):
    """GT with ignore (255) and negative entries, predictions past the
    class count."""
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, n_class, shape).astype(np.int32)
    gt[rng.rand(*shape) < 0.1] = 255
    gt[rng.rand(*shape) < 0.05] = -1
    pred = rng.randint(0, n_class + 3, shape).astype(np.int32)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_hist_t_equals_fast_hist_jnp(seed):
    gt, pred = _labels(seed, (33, 47))
    got = pmetrics.fast_hist_t(torch.tensor(gt), torch.tensor(pred), N_CLASS)
    want = np.asarray(jmetrics.fast_hist_jnp(jnp.asarray(gt),
                                             jnp.asarray(pred), N_CLASS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_hist_t_equals_per_image_numpy():
    gt, pred = _labels(3, (5, 16, 16))
    got = pmetrics.batch_hist_t(torch.tensor(gt), torch.tensor(pred), N_CLASS)
    for i in range(5):
        keep = (gt[i] >= 0) & (gt[i] < N_CLASS)
        want = pmetrics.fast_hist(gt[i][keep],
                                  np.minimum(pred[i][keep], N_CLASS - 1),
                                  N_CLASS)
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.fixture(scope="module")
def runners():
    jcfg = jcfg_mod.PipelineConfig.tiny()
    pcfg = pcfg_mod.PipelineConfig.tiny()
    jcfg = dataclasses.replace(
        jcfg, attribution=dataclasses.replace(jcfg.attribution, layer=1))
    pcfg = dataclasses.replace(
        pcfg, attribution=dataclasses.replace(pcfg.attribution, layer=1))
    params = init_params(jax.random.PRNGKey(0), jcfg.model,
                         capture_layers=(0,))
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg.model,
                            capture_layers=(0,), device="cpu")
    return (JaxRunner(jcfg, params, attn_impl="xla", bucket_size=16,
                      bilateral_impl="reference"),
            SegmentationRunner(pcfg, model, device="cpu", bucket_size=16))


@pytest.mark.parametrize("seed", [0, 1])
def test_make_hist_fn_equals_jax(runners, seed):
    jrunner, prunner = runners
    rng = np.random.RandomState(seed)
    b, k = 3, 6
    labels = rng.randint(0, k, (b, 16, 16)).astype(np.uint8)
    tables = np.zeros((b, k), np.int32)
    tables[:, 1:] = rng.randint(1, N_CLASS, (b, k - 1))
    tables[-1] = 0  # a padded row maps everything to background
    gt, _ = _labels(seed + 10, (b, 16, 16))
    got = prunner.make_hist_fn(N_CLASS)(
        torch.tensor(labels), torch.tensor(tables), torch.tensor(gt))
    want = jrunner.make_hist_fn(N_CLASS)(
        jnp.asarray(labels), jnp.asarray(tables), jnp.asarray(gt))
    assert got.shape == (b, N_CLASS, N_CLASS) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_result_keeps_labels_on_the_device():
    """``materialize_labels=False`` hands back the tensors, not copies."""
    labels = torch.randint(0, 5, (2, 2, 8, 8), dtype=torch.uint8)
    pending = PendingBatch(labels_dev=labels, num_classes=np.ones(2),
                           bg_enable=np.ones(2, bool))
    kept = pending.result(materialize_labels=False)
    assert torch.is_tensor(kept.labels_agg)
    assert kept.labels_agg.data_ptr() == labels[:, 1].data_ptr()
    host = pending.result()
    np.testing.assert_array_equal(host.labels_r0, labels[:, 0].numpy())


def _hist_files(root, seed):
    rng = np.random.RandomState(seed)
    for sub, n in zip(jagg.HIST_DIRS, (4, 3)):
        d = os.path.join(root, sub)
        os.makedirs(d)
        for i in range(n):
            h = rng.randint(0, 50, (N_CLASS, N_CLASS))
            h[rng.rand(N_CLASS) < 0.3] = 0  # classes absent from the GT
            np.save(os.path.join(d, f"img_{i}_x.npy"), h)
        open(os.path.join(d, "notes.txt"), "w").close()  # not a hist


def _assert_tables_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "Class IoU":
            assert list(got[k]) == list(want[k])
            np.testing.assert_allclose(list(got[k].values()),
                                       list(want[k].values()), rtol=1e-12)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_equals_jax(tmp_path, seed):
    _hist_files(str(tmp_path), seed)
    got = pagg.aggregate(str(tmp_path), "voc")
    want = jagg.aggregate(str(tmp_path), "voc")
    assert list(got) == list(want) == list(jagg.HIST_DIRS)
    for sub in want:
        _assert_tables_equal(got[sub], want[sub])
        np.testing.assert_array_equal(
            pagg.sum_hist_dir(str(tmp_path / sub)),
            jagg.sum_hist_dir(str(tmp_path / sub)))
    assert pagg.sum_hist_dir(str(tmp_path / "absent")) is None


def test_aggregate_main_prints_like_jax(tmp_path, capsys):
    _hist_files(str(tmp_path), 2)
    argv = ["--save_path", str(tmp_path), "--data_type", "voc"]
    jagg.main(argv)
    want = capsys.readouterr().out
    pagg.main(argv)
    assert capsys.readouterr().out == want
    pagg.main(["--save_path", str(tmp_path / "none"), "--data_type", "voc"])
    assert "no histogram directories" in capsys.readouterr().out


@pytest.mark.parametrize("data_type", ["voc", "coco_object"])
def test_scores_from_hist_equal_jax(data_type):
    meta = get_dataset_meta(data_type)
    rng = np.random.RandomState(5)
    hist = rng.randint(0, 1000, (meta.n_class, meta.n_class)).astype(float)
    hist[:, 3] = 0
    hist[4] = 0
    names = meta.metric_class_names()
    _assert_tables_equal(pmetrics.scores_from_hist(hist, names),
                         jmetrics.scores_from_hist(hist, names))
    cats = {i: f"c{i}" for i in range(1, 6)}
    assert pmetrics.class_name_list(cats, 6) == \
        jmetrics.class_name_list(cats, 6)
