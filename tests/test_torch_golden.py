"""The port reproduces the JAX package's pinned tiny pipeline.

``tests/golden_tiny_pipeline.npz`` pins the JAX runner's outputs on the
tiny config with the exact CRF (``bilateral_subsample=1``, 2 iterations),
pre-normalised float images and no GT sizes (tests/test_golden.py). The
port's runner, built from the same ``init_params`` draw through
``from_jax_params``, runs the same inputs on the CPU (plain versions of
every kernel, K8 among them) and is held to test_golden.py's own bars:
map sums within rtol 1e-3, labels more than 99.5% equal.
"""

import dataclasses
import os

import jax
import numpy as np

from pnp_ovss_tpu.config import PipelineConfig as JaxPipelineConfig
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.text.captions import build_caption_batch
from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
from pnp_ovss_tpu_torch.config import (
    CRFConfig, PipelineConfig, PostprocessConfig,
)
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

NMS = ["dog", "cat", "grass", "sky"]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_tiny_pipeline.npz")


def test_port_matches_tiny_pipeline_golden():
    cfg = PipelineConfig.tiny()
    cfg = dataclasses.replace(
        cfg,
        attribution=dataclasses.replace(cfg.attribution, layer=1, head=1),
        postprocess=PostprocessConfig(
            mode="blur+crf", crf=CRFConfig(num_iters=2),
            bilateral_subsample=1),
        batch_size=4)
    params = init_params(jax.random.PRNGKey(0),
                         JaxPipelineConfig.tiny().model, capture_layers=(0,))
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    rng = np.random.RandomState(42)
    images = rng.rand(4, cfg.img_size, cfg.img_size, 3).astype(np.float32)
    cap = build_caption_batch(
        [["dog", "grass"], ["cat"], ["sky", "dog"], ["grass"]], tok,
        max_text_len=cfg.model.max_text_len, max_classes=cfg.max_classes)
    rgb = rng.randint(0, 255, (4, 32, 32, 3)).astype(np.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg.model,
                            capture_layers=(0,), device="cpu")
    runner = SegmentationRunner(cfg, model, device="cpu", bucket_size=32)
    res = runner.run_batch(images, cap, rgb, return_maps=True)

    want = np.load(GOLDEN)
    np.testing.assert_allclose(res.maps_agg.sum(axis=(2, 3)),
                               want["maps_agg_sum"], rtol=1e-3, atol=1e-5)
    assert (res.labels_r0 == want["labels_r0"]).mean() > 0.995
    assert (res.labels_agg == want["labels_agg"]).mean() > 0.995
    assert len(np.unique(res.labels_agg)) > 1
