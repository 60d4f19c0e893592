"""The port's host parity path against the JAX package's, on the CPU.

``ops/host_post.py`` (numpy resize, Scale_0_1, blur + min-max) within 1e-5
of the JAX package's; the port's own build of the native lattice
(``ops/crf_host.py``, portable flags, ``build/densecrf/``) against the JAX
package's binding of the same source: ``permutohedral_filter`` within 1e-4
relative, ``densecrf_labels`` equal on at least 99.9% of pixels (the two
libraries are compiled with different flags, so FMA contraction may move
the last bits); ``finalize_image_parity`` for both variants on the inputs
of ``tests/test_host_post.py``; ``submit_batch(return_grid_maps=True)``
against the JAX runner on one weight draw; the port-side synthetic gate's
scenes and anchor labels against the JAX gate's; and a build of the
lattice by four processes at once.
"""

import dataclasses
import importlib.util
import multiprocessing as mp
import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.ops import crf_host as jax_crf_host
from pnp_ovss_tpu.ops import host_post as jax_host_post
from pnp_ovss_tpu.pipeline.runner import SegmentationRunner as JaxRunner
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.ops import crf_host, host_post
from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

REPO = Path(__file__).resolve().parents[1]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name.replace("/", "_"), REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("out", [(60, 80), (375, 500)])
def test_resize_matches_jax(out):
    x = np.random.RandomState(0).rand(3, 21, 21).astype(np.float32)
    np.testing.assert_allclose(host_post.resize_bilinear_np(x, *out),
                               jax_host_post.resize_bilinear_np(x, *out),
                               rtol=1e-5, atol=1e-5)


def test_rescale_matches_jax():
    x = np.random.RandomState(3).rand(4, 8, 8).astype(np.float32) * 5 - 1
    x[2] = 0.7  # a constant map
    np.testing.assert_allclose(host_post.rescale_0_1_np(x),
                               jax_host_post.rescale_0_1_np(x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape, sigma", [((2, 40, 50), 2.5),
                                          ((6, 375, 500), 25.0)])
def test_blur_and_minmax_matches_jax(shape, sigma):
    """Float64 BLAS products against the JAX package's float32 einsum, at
    a small shape and at a VOC GT size with the blur's sigma there."""
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    np.testing.assert_allclose(host_post.blur_and_minmax_np(x, sigma),
                               jax_host_post.blur_and_minmax_np(x, sigma),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n, d, c", [(300, 2, 3), (900, 5, 4)])
def test_permutohedral_filter_matches_jax(n, d, c):
    rng = np.random.RandomState(n)
    feats = rng.rand(n, d).astype(np.float32) * 4
    vals = rng.rand(n, c).astype(np.float32)
    got = crf_host.permutohedral_filter(feats, vals)
    want = jax_crf_host.permutohedral_filter(feats, vals)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def _crf_scene(seed, h=60, w=72, c=4):
    rng = np.random.RandomState(seed)
    image = np.zeros((h, w, 3), np.float32)
    image[:, : w // 2] = [200, 30, 30]
    image[:, w // 2:] = [30, 30, 200]
    image += rng.randn(h, w, 3) * 12
    logits = rng.rand(c, h, w).astype(np.float32)
    logits[1, :, : w // 2] += 0.8
    logits[2, :, w // 2:] += 0.8
    return logits, np.clip(image, 0, 255)


@pytest.mark.parametrize("seed", [0, 1])
def test_densecrf_labels_match_jax(seed):
    logits, image = _crf_scene(seed)
    cfg = pcfg_mod.CRFConfig()
    got = crf_host.densecrf_labels(logits, image, cfg)
    want = jax_crf_host.densecrf_labels(logits, image, jcfg_mod.CRFConfig())
    assert got.dtype == np.int32 and got.shape == logits.shape[1:]
    assert len(np.unique(got)) > 1
    assert (got == want).mean() >= 0.999, (got == want).mean()


def _parity_runners(mode):
    def cfg(mod):
        c = mod.PipelineConfig.tiny()
        return dataclasses.replace(c, postprocess=dataclasses.replace(
            c.postprocess, mode=mode))

    port = SegmentationRunner(cfg(pcfg_mod), None, device="cpu",
                              bucket_size=32)
    jax_run = JaxRunner(cfg(jcfg_mod), params={}, bucket_size=32,
                        bilateral_impl="reference")
    return port, jax_run


@pytest.mark.parametrize("mode", ["", "blur+crf"])
@pytest.mark.parametrize("rescale", [False, True], ids=["agg", "r0"])
def test_finalize_image_parity_matches_jax(mode, rescale):
    """``tests/test_host_post.py``'s inputs: two classes of grid maps at
    45 x 61 GT (the r0 variant min-maxes after the resize)."""
    port, jax_run = _parity_runners(mode)
    rng = np.random.RandomState(4)
    g = port.cfg.model.vit.grid
    kmax = port.cfg.max_classes
    k, h, w = 2, 45, 61
    maps_grid = np.zeros((kmax, g, g), np.float32)
    maps_grid[:k] = rng.rand(k, g, g) * (rng.rand(k, g, g) > 0.5)
    class_valid = np.arange(kmax) < k
    rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    args = (maps_grid, True, class_valid, [5, 9], rgb, (h, w))
    got = port.finalize_image_parity(*args, rescale=rescale)
    want = jax_run.finalize_image_parity(*args, rescale=rescale)
    assert got.shape == (h, w) and set(np.unique(got)) <= {0, 5, 9}
    if mode:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)


def test_submit_batch_returns_grid_maps(monkeypatch):
    """The grid-resolution thresholded maps of both variants, copied to
    the host, against the JAX runner's on one weight draw (the unfused
    ViT, as ``tests/test_torch_pipeline.py``: map sums within rtol 1e-3);
    bucket maps stay None."""
    from pnp_ovss_tpu.models.blip_itm import init_params
    from pnp_ovss_tpu.text.captions import build_caption_batch
    from pnp_ovss_tpu.text.wordpiece import WordPieceTokenizer
    from pnp_ovss_tpu_torch.models.convert import from_jax_params

    monkeypatch.setenv("PNP_VIT_FUSED", "0")
    jcfg, pcfg = (dataclasses.replace(
        mod.PipelineConfig.tiny(),
        attribution=mod.AttributionConfig(layer=1, head=1))
        for mod in (jcfg_mod, pcfg_mod))
    params = init_params(jax.random.PRNGKey(0), jcfg.model,
                         capture_layers=(0,))
    tok = WordPieceTokenizer.toy(["a", "picture", "of", "dog", "cat"])
    cap = build_caption_batch([["dog"], ["cat", "dog"]], tok,
                              max_text_len=jcfg.model.max_text_len,
                              max_classes=jcfg.max_classes)
    rng = np.random.RandomState(0)
    b, s = 2, jcfg.img_size
    images = rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8)
    rgb = (rng.rand(b, 32, 32, 3) * 255).astype(np.uint8)
    want = JaxRunner(jcfg, params, attn_impl="xla", bucket_size=32,
                     bilateral_impl="reference").submit_batch(
        images, cap, rgb, return_grid_maps=True).result()
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg.model,
                            capture_layers=(0,), device="cpu", vit_fused=False)
    got = SegmentationRunner(pcfg, model, device="cpu", bucket_size=32) \
        .submit_batch(images, cap, rgb, return_grid_maps=True).result()
    g = pcfg.model.vit.grid
    assert got.maps_r0 is None and got.maps_agg is None
    for name in ("grid_r0", "grid_agg"):
        a, w = getattr(got, name), getattr(want, name)
        assert isinstance(a, np.ndarray) and a.shape == (b, 4, g, g)
        assert a.min() >= 0 and np.all(a[0, cap.class_valid[0] == 0] == 0)
        np.testing.assert_allclose(a.sum(axis=(2, 3)), w.sum(axis=(2, 3)),
                                   rtol=1e-3, atol=1e-5)


def test_gate_scenes_and_anchor_match_the_jax_gate():
    """The port-side gate draws the JAX gate's scenes from the same seed,
    and its anchor (host parity path) labels the first two as the JAX
    gate's anchor does."""
    gate = _load_script("synthetic_postprocess_gate_torch")
    jgate = _load_script("synthetic_postprocess_gate")
    from pnp_ovss_tpu.pipeline import masks as jmasks

    pcfg = pcfg_mod.PipelineConfig()
    jcfg = jcfg_mod.PipelineConfig()
    grid, kmax = pcfg.model.vit.grid, pcfg.max_classes
    scenes = gate.make_scenes(0, 2, 6, grid)
    rng = np.random.RandomState(0)
    port_run = SegmentationRunner(pcfg, None, device="cpu")
    jax_run = JaxRunner(jcfg, params={}, bucket_size=224,
                        bilateral_impl="reference")
    tgrids = [gate.threshold_grid(maps, k, pcfg)
              for (_, _, maps), _, k in scenes]
    got = gate.anchor_labels(port_run, scenes, tgrids, workers=2)
    for i, ((gt, rgb, maps), (h, w), k) in enumerate(scenes):
        hh, ww = jgate.SIZES[i % len(jgate.SIZES)]
        kk = int(rng.randint(2, 7))
        jgt, jrgb, jmaps = jgate.make_scene(rng, hh, ww, kk, grid)
        assert (h, w, k) == (hh, ww, kk)
        np.testing.assert_allclose(maps, jmaps, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(gt, jgt)
        padded = np.zeros((1, kmax, grid, grid), np.float32)
        padded[0, :k] = jmaps
        jtg = np.asarray(jmasks.threshold_maps(jnp.asarray(padded),
                                               jcfg.threshold)[0])
        np.testing.assert_allclose(tgrids[i], jtg, rtol=1e-6, atol=1e-6)
        want = jax_run.finalize_image_parity(
            jtg, True, np.arange(kmax) < k, list(range(1, k + 1)), jrgb,
            (h, w), rescale=False)
        assert (got[i] == want).mean() >= 0.999, (got[i] == want).mean()


def _build_in(build_dir, conn):
    """Build and load the lattice into ``build_dir`` with every
    ``subprocess.run`` command and ``os.replace`` target recorded."""
    from pnp_ovss_tpu_torch.ops import crf_host as mod

    calls, real_run, real_replace = [], subprocess.run, os.replace

    def run(cmd, *args, **kw):
        calls.append(("run", [str(c) for c in cmd]))
        return real_run(cmd, *args, **kw)

    def replace(src, dst, *args, **kw):
        calls.append(("replace", [str(src), str(dst)]))
        return real_replace(src, dst, *args, **kw)

    mod.subprocess.run, mod.os.replace = run, replace
    mod.BUILD_DIR = Path(build_dir)
    try:
        path = str(mod.library_path())
        mod._lib()
        conn.send((path, mod.available(), calls))
    except Exception as e:  # report to the parent rather than hang it
        conn.send(("error", repr(e), calls))


def test_lattice_builds_once_under_four_processes(tmp_path):
    """Four processes build the lattice into one empty directory at once:
    each loads a whole library, one ``.so`` is left and no temporary
    file. No process runs ``make`` or writes outside that directory (so
    never under ``native/``)."""
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(4)]
    procs = [ctx.Process(target=_build_in, args=(str(tmp_path), w))
             for _, w in pipes]
    for p in procs:
        p.start()
    results = [r.recv() for r, _ in pipes]
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    assert len({r[:2] for r in results}) == 1 and results[0][1] is True, \
        results
    assert [p.name for p in tmp_path.iterdir()] == \
        [Path(results[0][0]).name]
    calls = [c for r in results for c in r[2]]
    runs = [argv for kind, argv in calls if kind == "run"]
    assert runs and all(argv[0] == "g++" for argv in runs), runs
    written = [argv[argv.index("-o") + 1] for argv in runs] + \
        [argv[1] for kind, argv in calls if kind == "replace"]
    assert all(Path(w).parent == tmp_path for w in written), written


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No compiler: the parity path raises instead of skipping the CRF."""
    monkeypatch.setattr(crf_host, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    crf_host._lib.cache_clear()
    try:
        assert not crf_host.available()
        logits, image = _crf_scene(0)
        with pytest.raises((OSError, subprocess.CalledProcessError)):
            crf_host.densecrf_labels(logits, image, pcfg_mod.CRFConfig())
    finally:
        crf_host._lib.cache_clear()
