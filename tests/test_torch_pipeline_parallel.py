"""The port's pipeline-parallel encode and the runner's model-axis
strategies against the JAX package (``tests/test_pipeline_parallel.py``,
``tests/test_pipeline.py:152-186``).

The JAX side runs ``encode_images_pp`` on the conftest's virtual CPU
mesh; the port's ranks are one spawn of four gloo CPU processes for the
module (``tests/test_torch_sp_ranks.py``), regrouped into data 1 x pp 4
and data 2 x pp 2 meshes. Each data index encodes its rows of the batch,
so a rank is held against the same rows of the JAX result. Bars: the
JAX tests' 1e-5 in f32; on __graft_entry__.py's fused bf16 config the
pipelined encode equals the port's unsharded encode bit for bit (each
stage runs the unsharded blocks on its microbatch rows), and the same
config in f32 is within the fused whole-encode bar (2e-4,
tests/test_torch_vit_fused.py) of the JAX pipeline: in bf16 the two
packages round at other points and their unsharded encodes already
differ by up to six ulps (tests/test_torch_sequence_parallel.py). The
runner with "pp", and with "sp" at data 2, against the unsharded runner
at the sequence-parallel tests' bars.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.models.blip_itm import init_params
from pnp_ovss_tpu.parallel import mesh as jax_mesh
from pnp_ovss_tpu.parallel.pipeline import encode_images_pp as jax_pp
from pnp_ovss_tpu.text.captions import build_caption_batch
from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.models.blip_itm import init_blip_itm
from pnp_ovss_tpu_torch.models.convert import from_jax_params
from pnp_ovss_tpu_torch.parallel import mesh as port_mesh
from pnp_ovss_tpu_torch.parallel.pipeline import encode_images_pp
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner
from test_torch_sp_ranks import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_TOL = dict(rtol=2e-4, atol=2e-4)
NMS = ["dog", "cat", "grass", "sky"]
B, BUCKET = 4, 32


def _models(vit_kw, seed, *, fused):
    """The JAX ViT params and the port's BlipITM on the same weights."""
    tiny = jcfg_mod.ModelConfig.tiny()
    vit = dict(dataclasses.asdict(tiny.vit), **vit_kw)
    bert = dict(dataclasses.asdict(tiny.bert),
                encoder_width=vit["hidden_size"])
    jcfg = jcfg_mod.ModelConfig(vit=jcfg_mod.ViTConfig(**vit),
                                bert=jcfg_mod.BertConfig(**bert),
                                max_text_len=16, embed_dim=16)
    pcfg = pcfg_mod.ModelConfig(vit=pcfg_mod.ViTConfig(**vit),
                                bert=pcfg_mod.BertConfig(**bert),
                                max_text_len=16, embed_dim=16)
    params = init_params(jax.random.PRNGKey(seed), jcfg, capture_layers=(0,),
                         attn_impl="pallas" if fused else "xla")
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg,
                            capture_layers=(0,), device="cpu",
                            vit_fused=fused)
    assert model.visual_encoder.fused == fused
    return jcfg, {"params": params["params"]["visual_encoder"]}, model


def _pipeline_cfg(mod):
    """The fused narrow pipeline of the sequence-parallel tests (width
    128, 2 heads of 64, 192 px, f32; BERT tiny reading width 128)."""
    tiny = mod.ModelConfig.tiny()
    vit = dataclasses.replace(tiny.vit, image_size=192, hidden_size=128,
                              num_heads=2)
    cfg = mod.PipelineConfig.tiny()
    model = dataclasses.replace(
        cfg.model, vit=vit,
        bert=dataclasses.replace(cfg.model.bert, encoder_width=128))
    return dataclasses.replace(
        cfg, batch_size=B, model=model,
        attribution=dataclasses.replace(cfg.attribution, layer=1, head=1))


# --- rank functions -----------------------------------------------------


def rank_pp_encode(mesh, vit, images, model_parallel, microbatches):
    mesh = port_mesh.make_mesh_2d(model_parallel, ["cpu"] * mesh.world_size,
                                  rank=mesh.rank, init_method=None)
    # encode_images_pp cuts the model to this stage's blocks in place,
    # and the rank's other tasks share ``vit``.
    out = encode_images_pp(copy.deepcopy(vit), images, mesh,
                           num_microbatches=microbatches)
    return dict(out=out, data_rank=mesh.data_rank, data=mesh.data)


def rank_runner(mesh, kind, cfg, model, batch, gt):
    """One batch of the runner with ``encode_parallel=kind`` over data 2 x
    model 2, each data index on its half of the batch."""
    mesh = port_mesh.make_mesh_2d(2, ["cpu"] * mesh.world_size,
                                  rank=mesh.rank, init_method=None)
    runner = SegmentationRunner(cfg, model, device="cpu", bucket_size=BUCKET,
                                encode_parallel=kind, mesh=mesh)
    blocks = len(runner.model.visual_encoder.blocks)
    res = runner.run_batch(*batch[mesh.data_rank], return_maps=True,
                           gt_sizes=gt[mesh.data_rank])
    return dict(res=res, blocks=blocks)


def _halves(x):
    return [x[:len(x) // 2], x[len(x) // 2:]]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.RandomState(0)
    tasks, want = {}, {}

    # Tiny f32 ViT, xla attention, 4 layers (tests/test_pipeline_parallel.py
    # :38-57), at data 1 x pp 4 and data 2 x pp 2.
    jcfg, vparams, model = _models(dict(num_layers=4), 1, fused=False)
    images = rng.rand(8, jcfg.vit.image_size, jcfg.vit.image_size,
                      3).astype(np.float32)
    want["tiny_unsharded"] = model.encode_image(
        torch.from_numpy(images)).numpy()
    for pp in (4, 2):
        mesh = jax_mesh.make_mesh_2d(pp, jax.devices()[:4])
        want[f"tiny_pp{pp}"] = np.asarray(jax_pp(
            jcfg.vit, vparams, jnp.asarray(images), mesh, impl="xla"))
        tasks[f"tiny_pp{pp}"] = ("call", rank_pp_encode, model.visual_encoder,
                                 torch.from_numpy(images), pp, None)

    # M > pp: 16 images, data 2 x pp 2, 4 microbatches of 2 rows.
    jcfg, vparams, model = _models({}, 5, fused=False)
    images = rng.rand(16, jcfg.vit.image_size, jcfg.vit.image_size,
                      3).astype(np.float32)
    want["m4_unsharded"] = model.encode_image(
        torch.from_numpy(images)).numpy()
    tasks["m4"] = ("call", rank_pp_encode, model.visual_encoder,
                   torch.from_numpy(images), 2, 4)

    # __graft_entry__.py's fused config: hidden 128, 2 heads, 192 px, in
    # bf16 against the port's unsharded encode, in f32 against JAX.
    images = rng.rand(8, 192, 192, 3).astype(np.float32)
    fused = dict(image_size=192, hidden_size=128, num_heads=2)
    _, _, model = _models(dict(fused, dtype="bfloat16"), 3, fused=True)
    want["fused_unsharded"] = model.encode_image(torch.from_numpy(images))
    tasks["fused"] = ("call", rank_pp_encode, model.visual_encoder,
                      torch.from_numpy(images), 2, None)
    jcfg, vparams, model = _models(fused, 3, fused=True)
    mesh = jax_mesh.make_mesh_2d(2, jax.devices()[:4])
    want["fused_jax"] = np.asarray(jax_pp(
        jcfg.vit, vparams, jnp.asarray(images), mesh, impl="pallas"))
    tasks["fused32"] = ("call", rank_pp_encode, model.visual_encoder,
                        torch.from_numpy(images), 2, None)

    # The runner: each data index gets its own batch of B images.
    pcfg = _pipeline_cfg(pcfg_mod)
    model = init_blip_itm(pcfg.model, capture_layers=(0,), seed=5,
                          device="cpu")
    tok = WordPieceTokenizer.toy(["a", "picture", "of"] + NMS)
    names = [["dog", "grass"], ["cat"], ["sky", "dog", "cat"], ["grass"]]
    batches, gts = [], []
    for d in range(2):
        cap = build_caption_batch(names[d:] + names[:d], tok,
                                  max_text_len=pcfg.model.max_text_len,
                                  max_classes=pcfg.max_classes)
        batches.append((
            rng.randint(0, 256, (B, 192, 192, 3)).astype(np.uint8), cap,
            rng.randint(0, 255, (B, BUCKET, BUCKET, 3)).astype(np.float32)))
        gts.append([(375, 500), (500, 375), (300, 300), (240, 320)][d:]
                   + [(375, 500), (500, 375), (300, 300), (240, 320)][:d])
    unsharded = SegmentationRunner(pcfg, model, device="cpu",
                                   bucket_size=BUCKET)
    want["runner"] = [unsharded.run_batch(*batches[d], return_maps=True,
                                          gt_sizes=gts[d]) for d in range(2)]
    for kind in ("sp", "pp"):
        tasks[f"runner_{kind}"] = ("call", rank_runner, kind, pcfg, model,
                                   batches, gts)
    return run_ranks(tasks, ["cpu"] * 4, tmp), want


@pytest.mark.parametrize("pp", [4, 2], ids=["data1-pp4", "data2-pp2"])
def test_pp_encode_matches_jax_and_unsharded(ranks, pp):
    """Tiny f32 ViT, xla attention, one or two layers a stage: each rank
    returns its data index's rows of the JAX pipeline and of the
    unsharded encode (1e-5: the CPU's f32 products block the rows of a
    microbatch differently)."""
    outs, want = ranks
    for out in outs:
        got = out[f"tiny_pp{pp}"]
        d, data = got["data_rank"], got["data"]
        assert data == 4 // pp
        rows = slice(d * 8 // data, (d + 1) * 8 // data)
        np.testing.assert_allclose(got["out"].numpy(),
                                   want[f"tiny_pp{pp}"][rows], **TOL)
        np.testing.assert_allclose(got["out"].numpy(),
                                   want["tiny_unsharded"][rows], **TOL)


def test_pp_fused_encode_equals_unsharded(ranks):
    """The fused config at data 2 x pp 2 (K1, K2 and K3's plain versions
    on microbatch rows): in bf16 bit-equal to the port's unsharded
    encode; in f32 within the fused encode's bar of the JAX pipeline
    with its Pallas kernels in interpret mode."""
    outs, want = ranks
    for out in outs:
        got = out["fused"]
        rows = slice(got["data_rank"] * 4, got["data_rank"] * 4 + 4)
        assert got["out"].dtype == torch.bfloat16
        assert torch.equal(got["out"], want["fused_unsharded"][rows])
        np.testing.assert_allclose(out["fused32"]["out"].numpy(),
                                   want["fused_jax"][rows], **FUSED_TOL)


def test_pp_more_microbatches_than_stages(ranks):
    """M = 4 > pp = 2 at data 2: 8 rows a data index in microbatches of 2
    against the unsharded encode."""
    outs, want = ranks
    for out in outs:
        got = out["m4"]
        rows = slice(got["data_rank"] * 8, got["data_rank"] * 8 + 8)
        np.testing.assert_allclose(got["out"].numpy(),
                                   want["m4_unsharded"][rows], **TOL)


def _fake_mesh(data, model):
    """A mesh object for checks that raise before any collective."""
    return port_mesh.ProcessMesh(
        world_size=data * model, rank=0, data=data, model=model,
        backend="gloo", data_axis=port_mesh.AxisGroup(None, data, 0),
        model_axis=port_mesh.AxisGroup(None, model, 0))


@pytest.mark.parametrize("layers,batch,dp,pp,m,match", [
    (2, 8, 1, 4, None, "num_layers"),
    (4, 7, 2, 2, None, "dp=2"),
    (4, 8, 1, 4, 3, "num_microbatches"),
], ids=["layers", "batch", "microbatches"])
def test_pp_rejects_indivisible_shapes(layers, batch, dp, pp, m, match):
    """The JAX checks and messages (``pipeline.py:106-118``), raised
    before any collective."""
    cfg = dataclasses.replace(pcfg_mod.ModelConfig.tiny().vit,
                              num_layers=layers)
    from pnp_ovss_tpu_torch.models.vit import VisionTransformer

    vit = VisionTransformer(cfg)
    images = torch.zeros(batch, cfg.image_size, cfg.image_size, 3)
    with pytest.raises(ValueError, match=match):
        encode_images_pp(vit, images, _fake_mesh(dp, pp),
                         num_microbatches=m)


@pytest.mark.parametrize("kind", ["sp", "pp"])
def test_runner_model_axis_matches_unsharded(ranks, kind):
    """The runner with ``encode_parallel=kind`` at data 2 x model 2: each
    data index's maps and labels against the unsharded runner on its
    batch (map sums rtol 1e-3, > 99.5% of labels), and both model ranks
    return the same. Under "pp" a rank keeps one of the two blocks."""
    outs, want = ranks
    for r, out in enumerate(outs):
        got = out[f"runner_{kind}"]
        assert got["blocks"] == (1 if kind == "pp" else 2)
        res, ref = got["res"], want["runner"][r // 2]
        for name in ("maps_r0", "maps_agg"):
            a, b = getattr(res, name), getattr(ref, name)
            assert a.shape == b.shape == (B, 4, BUCKET, BUCKET)
            np.testing.assert_allclose(a.sum(axis=(2, 3)),
                                       b.sum(axis=(2, 3)), rtol=1e-3,
                                       atol=1e-5)
        for name in ("labels_r0", "labels_agg"):
            assert (getattr(res, name) == getattr(ref, name)).mean() > 0.995
            np.testing.assert_array_equal(
                getattr(res, name),
                getattr(outs[r ^ 1][f"runner_{kind}"]["res"], name))


@pytest.mark.parametrize("kind", ["sp", "pp"])
@pytest.mark.parametrize("mesh", [None, (2, 1)], ids=["no_mesh", "data"])
def test_runner_encode_parallel_needs_model_axis(kind, mesh):
    """"sp" and "pp" without a model axis raise "2D", as the JAX runner
    (``tests/test_pipeline.py:172-186``)."""
    cfg = _pipeline_cfg(pcfg_mod)
    model = init_blip_itm(cfg.model, capture_layers=(0,), device="cpu")
    with pytest.raises(ValueError, match="2D"):
        SegmentationRunner(cfg, model, device="cpu", encode_parallel=kind,
                           mesh=None if mesh is None else _fake_mesh(*mesh))
