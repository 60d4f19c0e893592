"""The plain reference against the port on the CPU at test widths, on
seeded weights: piece by piece, and through a whole run of the narrow
cell. (A test may import the port; the reference may not.)"""

import json

import numpy as np
import pytest
import torch

from port_bench import traffic as traffic_mod
from port_bench import weights
from port_bench.reference import segment as ref
from port_bench.reference.blip_itm import BlipItm, resample_pos_embed
from port_bench.tests import tiny

CFG = json.loads((tiny.DATA / "tiny.json").read_text())
TRAFFIC = json.loads((tiny.DATA / "tiny_voc.json").read_text())
LIMITS = json.loads((tiny.DATA / "tiny_limits.json").read_text())


@pytest.fixture(autouse=True)
def _f32_products():
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def test_the_same_seed_draws_the_same_weights():
    a = weights.lavis_state_dict(CFG["model"], 7, "cpu")
    b = weights.lavis_state_dict(CFG["model"], 7, "cpu")
    c = weights.lavis_state_dict(CFG["model"], 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["itm_head.weight"], c["itm_head.weight"])


def test_captions_match_the_ports():
    from pnp_ovss_tpu_torch.text.captions import (
        build_caption_batch, fitted_text_len,
    )
    from pnp_ovss_tpu_torch.text.wordpiece import WordPieceTokenizer

    vocab = traffic_mod.vocab(TRAFFIC)
    lists = [["cat", "bus"], ["bird"], ["boat", "bus", "car", "bottle"]]
    tok = WordPieceTokenizer(vocab)
    t = fitted_text_len(lists, tok, max_text_len=64)
    assert t == ref.caption_length(lists, 64)
    cap = build_caption_batch(lists, tok, max_text_len=t, max_classes=4)
    for i, names in enumerate(lists):
        ids, mask, pool = ref.caption(names, vocab, t, 4)
        np.testing.assert_array_equal(ids, cap.input_ids[i])
        np.testing.assert_array_equal(mask, cap.attention_mask[i])
        np.testing.assert_array_equal(pool, cap.pool_matrix[i])


def test_position_grid_resample_matches_the_ports():
    from pnp_ovss_tpu_torch.models.vit import interpolate_pos_embed

    pos = torch.randn(1, 1 + 24 * 24, 16, generator=torch.Generator()
                      .manual_seed(0))
    for grid in (21, 48):
        torch.testing.assert_close(resample_pos_embed(pos, grid),
                                   interpolate_pos_embed(pos, grid * grid))


def test_blur_matrix_matches_the_ports():
    from pnp_ovss_tpu_torch.ops.blur import _blur_matrix_np

    for n, sigma in ((192, 9.6), (32, 1.6)):
        np.testing.assert_allclose(ref.blur_matrix(n, sigma),
                                   _blur_matrix_np(n, sigma, 4.0),
                                   rtol=0, atol=1e-7)


def test_model_in_float32_matches_the_ports():
    """The port built in float32 from the same state dict gives the
    reference's embeddings and GradCAM to float32 rounding."""
    import dataclasses

    from pnp_ovss_tpu_torch.attribution.gradcam import gradcam_from_embeds
    from pnp_ovss_tpu_torch.models.convert import from_lavis_state_dict
    from port_bench.systems.segmentation_runner import port_config

    sd = weights.lavis_state_dict(CFG["model"], 5, "cpu")
    vocab = traffic_mod.vocab(TRAFFIC)
    pcfg = port_config(CFG["model"], CFG["pipeline"], "float32",
                       vocab["[ENC]"])
    model = from_lavis_state_dict(sd, pcfg.model, capture_layers=(0,),
                                  device="cpu")
    refm = BlipItm(sd, CFG["model"], device="cpu")
    g = torch.Generator().manual_seed(1)
    images = torch.randn(2, 48, 48, 3, generator=g)
    emb = model.encode_image(images)
    torch.testing.assert_close(emb, refm.encode(images), rtol=1e-4,
                               atol=1e-4)
    ids, mask, _ = ref.caption(["cat", "bus"], vocab, 64, 4)
    ids_t = torch.as_tensor(ids)[None].repeat(2, 1)
    mask_t = torch.as_tensor(mask)[None].repeat(2, 1)
    gc, logits = gradcam_from_embeds(model, emb, ids_t, mask_t, grid=3)
    gc_ref, logits_ref = refm.gradcam(emb, ids_t, mask_t, layer=1, head=1)
    torch.testing.assert_close(logits, logits_ref, rtol=1e-4, atol=1e-5)
    scale = float(gc_ref.abs().max())
    assert float((gc[0, :, 1] - gc_ref).abs().max()) <= 1e-4 * scale
    assert dataclasses.is_dataclass(pcfg)


def test_crf_matches_the_ports_on_the_cpu():
    from pnp_ovss_tpu_torch.config import CRFConfig
    from pnp_ovss_tpu_torch.ops import crf as crf_mod

    g = torch.Generator().manual_seed(2)
    rgb = traffic_mod.photo_like(32, 32, 2, g)
    logits = torch.rand(2, 5, 32, 32, generator=g)
    logits[:, 3:] = ref.DISABLED
    crf = CFG["pipeline"]["postprocess"]["crf"]
    for s in (4, 1):
        labels = crf_mod.mean_field_crf_variants(
            logits, rgb, CRFConfig(**crf), bilateral_subsample=s,
            xy_scale=torch.tensor([0.8, 0.6]))
        q = ref.mean_field(logits, rgb, crf, subsample=s,
                           xy_scale=(0.8, 0.6))
        gap = q.amax(1) - q.gather(1, labels.reshape(2, 1, -1))[:, 0]
        assert float(gap.mean()) < 2e-3, s


def test_a_run_of_the_narrow_cell_is_correct(tmp_path):
    res, _ = tiny.run(tmp_path, seed=3, limits=LIMITS)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(LIMITS) - {"readings"}
    assert res["metrics"]["img_s"]["value"] > 0
    assert list(res)[-1] == "checks"
