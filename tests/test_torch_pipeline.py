"""The port's whole segmentation slice vs the JAX runner.

Same weights (``from_jax_params``), uint8 images, captions, bucket RGB and
GT sizes go through the port's ``SegmentationRunner`` on the CPU (plain
versions of every kernel) and the JAX package's runner with its Pallas
kernels in interpret mode (``attn_impl="pallas"``,
``bilateral_impl="pallas"``, unfused ViT block via ``PNP_VIT_FUSED=0``;
the port's ``vit_fused=False``).
Each test runs twice, over the postprocess (blur + 10-iteration CRF at
bucket 32): the default strided s=4 CRF (K5, K6) and the exact s=1 CRF
(K8, with the JAX runner's K8 in interpret mode). The bars are
tests/test_golden.py's: map sums within rtol 1e-3 and more than 99.5% of
labels equal (top-k and threshold ties may flip a few).
"""

import dataclasses

import jax
import numpy as np
import pytest

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.pipeline.runner import SegmentationRunner as JaxRunner
from pnp_ovss_tpu.text.captions import build_caption_batch
from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

NMS = ["dog", "cat", "grass", "sky"]
B, BUCKET = 4, 32


def _tiny(mod, subsample):
    cfg = mod.PipelineConfig.tiny()
    return dataclasses.replace(
        cfg, batch_size=B,
        attribution=dataclasses.replace(cfg.attribution, layer=1, head=1),
        postprocess=dataclasses.replace(cfg.postprocess,
                                        bilateral_subsample=subsample))


@pytest.fixture(scope="module", params=[4, 1],
                ids=["strided_s4", "exact_s1"])
def results(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("PNP_VIT_FUSED", "0")
    jcfg = _tiny(jcfg_mod, request.param)
    pcfg = _tiny(pcfg_mod, request.param)
    params = init_params(jax.random.PRNGKey(0), jcfg.model,
                         capture_layers=(0,))
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    cap = build_caption_batch(
        [["dog", "grass"], ["cat"], ["sky", "dog", "cat"], ["grass"]], tok,
        max_text_len=jcfg.model.max_text_len, max_classes=jcfg.max_classes)
    rng = np.random.RandomState(42)
    images = rng.randint(0, 256, (B, jcfg.img_size, jcfg.img_size, 3)) \
        .astype(np.uint8)
    rgb = rng.randint(0, 255, (B, BUCKET, BUCKET, 3)).astype(np.float32)
    gt = [(375, 500), (500, 375), (300, 300), (240, 320)]

    jrun = JaxRunner(jcfg, params, attn_impl="pallas", bucket_size=BUCKET,
                     bilateral_impl="pallas")
    want = jrun.run_batch(images, cap, rgb, return_maps=True, gt_sizes=gt)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg.model,
                            capture_layers=(0,), device="cpu", vit_fused=False)
    prun = SegmentationRunner(pcfg, model, device="cpu", bucket_size=BUCKET)
    got = prun.run_batch(images, cap, rgb, return_maps=True, gt_sizes=gt)
    yield jrun, prun, want, got
    mp.undo()


def test_maps_match_jax_runner(results):
    _, _, want, got = results
    for name in ("maps_r0", "maps_agg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape == (B, 4, BUCKET, BUCKET)
        np.testing.assert_allclose(a.sum(axis=(2, 3)), b.sum(axis=(2, 3)),
                                   rtol=1e-3, atol=1e-5)


def test_labels_match_jax_runner(results):
    _, _, want, got = results
    for name in ("labels_r0", "labels_agg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape == (B, BUCKET, BUCKET)
        assert (a == b).mean() > 0.995, (name, (a == b).mean())
    assert len(np.unique(got.labels_agg)) > 1
    np.testing.assert_array_equal(got.bg_enable, want.bg_enable)


def test_finalize_image_matches_jax_runner(results):
    jrun, prun, want, got = results
    a = prun.finalize_image(got.labels_agg[0], [1, 3], (40, 52))
    b = jrun.finalize_image(got.labels_agg[0], [1, 3], (40, 52))
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) <= {0, 1, 3}
