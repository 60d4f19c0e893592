"""The port's sequence-parallel encode (kernel K7's path) on the CPU.

Ranks are processes spawned with the spawn start method and joined by gloo
through a ``FileStore`` under ``tmp_path`` (``tests/test_torch_sp_ranks.py``);
every rank computes with the plain versions of the kernels. Four holds:
K7's plain version against the JAX ``flash_mha_flat_xlen`` (interpret mode);
the port's sharded encode against its unsharded encode at sp = 2 and 4; the
fused narrow encode against the JAX package's ``encode_images_sp``; and
``SegmentationRunner(encode_parallel="sp")`` against the unsharded runner.
The K7 kernel itself is held bit-equal to K2's rows on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.ops import flash_attention as jax_flash
from pnp_ovss_tpu.parallel import mesh as jax_mesh
from pnp_ovss_tpu.parallel.sequence import encode_images_sp as jax_sp
from pnp_ovss_tpu.text.captions import build_caption_batch
from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.models.vit import VisionTransformer
from pnp_ovss_tpu_torch.ops import flash_attention as port_flash
from pnp_ovss_tpu_torch.parallel.mesh import make_mesh_2d
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner
from test_torch_sp_ranks import run_ranks

TOL = dict(rtol=2e-4, atol=2e-4)  # f32, summation order only
NMS = ["dog", "cat", "grass", "sky"]
B, BUCKET = 4, 32


@pytest.mark.parametrize("lo,hi", [(0, 128), (128, 256), (384, 512)])
def test_xlen_plain_matches_jax_kernel(lo, hi):
    """K7's plain version on a query chunk against the JAX kernel
    (tests/test_sequence_parallel.py's chunks of 512 rows, 443 real);
    rows >= true_kv_len are padding by contract."""
    b, s, h, d, tl = 2, 512, 2, 64, 443
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(b, s, h * d).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash.flash_mha_flat_xlen(
        jnp.asarray(q[:, lo:hi]), jnp.asarray(k), jnp.asarray(v),
        num_heads=h, true_kv_len=tl))
    got = port_flash.flash_mha_flat_xlen(
        torch.from_numpy(q[:, lo:hi]), torch.from_numpy(k),
        torch.from_numpy(v), num_heads=h, true_kv_len=tl).numpy()
    assert got.shape == (b, hi - lo, h * d)
    rows = min(hi, tl) - lo
    np.testing.assert_allclose(got[:, :rows], want[:, :rows], **TOL)


def _pipeline_cfgs(vit_dtype: str):
    """Narrow fused pipeline configs for both packages: the ViT of width
    128, 2 heads of 64, 192 px (145 tokens) in ``vit_dtype``, BERT tiny
    reading width 128; bucket-32 strided CRF."""
    tiny = jcfg_mod.ModelConfig.tiny()
    vit_kw = dict(dataclasses.asdict(tiny.vit), image_size=192,
                  hidden_size=128, num_heads=2, dtype=vit_dtype)
    out = []
    for mod in (jcfg_mod, pcfg_mod):
        cfg = mod.PipelineConfig.tiny()
        bert = dataclasses.replace(cfg.model.bert, encoder_width=128)
        model = dataclasses.replace(cfg.model, vit=mod.ViTConfig(**vit_kw),
                                    bert=bert)
        out.append(dataclasses.replace(
            cfg, batch_size=B, model=model,
            attribution=dataclasses.replace(cfg.attribution, layer=1,
                                            head=1)))
    return out


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    """One spawn of two ranks for every sp = 2 task, with the inputs and
    the unsharded references made here."""
    tmp = tmp_path_factory.mktemp("sp2")
    rng = np.random.RandomState(0)
    tasks, want = {}, {}

    tiny = pcfg_mod.ModelConfig.tiny().vit
    torch.manual_seed(0)
    vit = VisionTransformer(tiny).requires_grad_(False)
    for p in vit.parameters():
        p.normal_(0, 0.2)
    images = torch.from_numpy(
        rng.rand(3, tiny.image_size, tiny.image_size, 3).astype(np.float32))
    tasks["tiny"] = ("encode", vit, images)
    with torch.no_grad():
        want["tiny"] = vit(images)

    jcfg, pcfg = _pipeline_cfgs("float32")
    params = init_params(jax.random.PRNGKey(3), jcfg.model,
                         capture_layers=(0,))
    images = rng.rand(2, 192, 192, 3).astype(np.float32)
    mesh = jax_mesh.make_mesh_2d(2, jax.devices()[:2])
    want["fused"] = np.asarray(jax_sp(
        jcfg.model.vit, {"params": params["params"]["visual_encoder"]},
        jnp.asarray(images), mesh, impl="pallas"), np.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg.model,
                            capture_layers=(0,), device="cpu")
    assert model.visual_encoder.fused
    tasks["fused"] = ("encode", model.visual_encoder,
                      torch.from_numpy(images))

    model = init_blip_itm(pcfg.model, capture_layers=(0,), seed=5,
                          device="cpu")
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    cap = build_caption_batch(
        [["dog", "grass"], ["cat"], ["sky", "dog", "cat"], ["grass"]], tok,
        max_text_len=pcfg.model.max_text_len, max_classes=pcfg.max_classes)
    batch = (rng.randint(0, 256, (B, 192, 192, 3)).astype(np.uint8), cap,
             rng.randint(0, 255, (B, BUCKET, BUCKET, 3)).astype(np.float32))
    gt = [(375, 500), (500, 375), (300, 300), (240, 320)]
    tasks["runner"] = ("run", pcfg, model, BUCKET, batch, gt)
    want["runner"] = SegmentationRunner(
        pcfg, model, device="cpu", bucket_size=BUCKET).run_batch(
        *batch, return_maps=True, gt_sizes=gt)
    return run_ranks(tasks, ["cpu"] * 2, tmp), want


def _sp4_tiny(tmp):
    tiny = pcfg_mod.ModelConfig.tiny().vit
    torch.manual_seed(1)
    vit = VisionTransformer(tiny).requires_grad_(False)
    for p in vit.parameters():
        p.normal_(0, 0.2)
    images = torch.from_numpy(np.random.RandomState(1).rand(
        2, tiny.image_size, tiny.image_size, 3).astype(np.float32))
    with torch.no_grad():
        want = vit(images)
    return run_ranks({"tiny": ("encode", vit, images)}, ["cpu"] * 4,
                     tmp), {"tiny": want}


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_encode_matches_unsharded(sp, sp2, tmp_path):
    """Tiny f32 ViT (head dim 16: the masked plain attention) split over
    sp ranks against the unsharded encode; at sp = 4 the 10 tokens pad to
    12, and the padded keys weigh 0. Every rank returns the whole encode."""
    ranks, want = sp2 if sp == 2 else _sp4_tiny(tmp_path)
    want = want["tiny"]
    for out in ranks:
        got = out["tiny"]
        assert got.shape == want.shape == (want.shape[0], 10, 32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_fused_sp_encode_matches_jax_encode_images_sp(sp2):
    """The fused narrow ViT (K1, K7, K3 plain versions) split over two
    ranks against the JAX package's ``encode_images_sp`` on a (data 1,
    model 2) mesh with its Pallas kernels in interpret mode. In f32, at
    the whole-encode bar of tests/test_torch_vit_fused.py, which is
    tighter than its BF16_TOL: in bf16 the two packages round at other
    points, and their unsharded encodes already differ by up to 0.047
    at |y| <= 4.2 (six bf16 ulps), sharded or not."""
    ranks, want = sp2
    for out in ranks:
        got = out["fused"].numpy()
        assert got.shape == want["fused"].shape == (2, 145, 128)
        np.testing.assert_allclose(got, want["fused"], **TOL)


def test_sp_runner_maps_match_unsharded_runner(sp2):
    """tests/test_golden.py's bar: map sums within rtol 1e-3; both ranks
    return the same maps."""
    ranks, want = sp2
    ref = want["runner"]
    for name in ("maps_r0", "maps_agg"):
        b = getattr(ref, name)
        assert np.abs(b).sum() > 0
        for out in ranks:
            a = getattr(out["runner"], name)
            assert a.shape == b.shape == (B, 4, BUCKET, BUCKET)
            np.testing.assert_allclose(a.sum(axis=(2, 3)),
                                       b.sum(axis=(2, 3)), rtol=1e-3,
                                       atol=1e-5)
        np.testing.assert_array_equal(getattr(ranks[0]["runner"], name),
                                      getattr(ranks[1]["runner"], name))


def test_sp_runner_labels_match_unsharded_runner(sp2):
    """More than 99.5% of labels equal, as tests/test_golden.py bars
    them; both ranks return the same labels."""
    ranks, want = sp2
    for name in ("labels_r0", "labels_agg"):
        b = getattr(want["runner"], name)
        for out in ranks:
            a = getattr(out["runner"], name)
            assert a.shape == b.shape == (B, BUCKET, BUCKET)
            assert (a == b).mean() > 0.995, (name, (a == b).mean())
        np.testing.assert_array_equal(getattr(ranks[0]["runner"], name),
                                      getattr(ranks[1]["runner"], name))
    assert len(np.unique(ranks[0]["runner"].labels_agg)) > 1


def _data_parallel(tmp):
    make_mesh_2d(2, ["cpu"] * 4, rank=0,
                 init_method=f"file://{tmp / 'store'}")


def _tiny_runner(**kw):
    cfg = pcfg_mod.PipelineConfig.tiny()
    cfg = dataclasses.replace(
        cfg, attribution=dataclasses.replace(cfg.attribution, layer=1))
    model = init_blip_itm(cfg.model, capture_layers=(0,), device="cpu")
    SegmentationRunner(cfg, model, device="cpu", **kw)


@pytest.mark.parametrize("call,exc", [
    (_data_parallel, NotImplementedError),
    (lambda tmp: _tiny_runner(encode_parallel="pp"), NotImplementedError),
    (lambda tmp: _tiny_runner(encode_parallel="sp"), ValueError)],
    ids=["data>1", "pp", "no_group"])
def test_unported_parallelism_raises(call, exc, tmp_path):
    """data > 1 and pipeline parallelism are not ported; "sp" without a
    group is an error. Nothing joins a process group on the way."""
    with pytest.raises(exc):
        call(tmp_path)
    assert not torch.distributed.is_initialized()

