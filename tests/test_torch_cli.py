"""The port's segmentation CLI against the JAX CLI on one set of weights.

A fake VOC directory (the layout of ``tests/test_cli.py``'s fixture: five
60x80 images, batch 4, so the second batch is a ragged tail of one) and one
tiny LAVIS-layout checkpoint, with the retrieval checkpoint's extra keys,
go through ``pnp_ovss_tpu.cli.segment.main`` and
``pnp_ovss_tpu_torch.cli.segment.main``, each with ``--checkpoint`` and
with its ``build_config`` monkeypatched to the tiny model widths. ``HOME``
points into ``tmp_path``, so neither parameter cache leaves the test.

Bars: per image, the r0 and agg hists differ by at most 1% of the image's
pixels in L1 (``test_golden.py``'s 99.5% label bar: a pixel whose label
differs moves two entries); the run totals' mIoU within 0.5 points.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from pnp_ovss_tpu import config as jcfg_mod
from pnp_ovss_tpu.cli import segment as jax_cli
from pnp_ovss_tpu.evalx.metrics import scores_from_hist as jax_scores
from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.cli import segment as port_cli
from pnp_ovss_tpu_torch.data.categories import get_dataset_meta
from pnp_ovss_tpu_torch.evalx.aggregate import aggregate
from pnp_ovss_tpu_torch.parallel.mesh import free_port
from tests.test_convert import (
    _retrieval_checkpoint_extras, _tiny_torch_state_dict,
)

H, W, N_IMG = 60, 80, 5
HIST_DIRS = ("hist_withfiltered_caption",
             "all_drop_hist_with_filtered_caption")
ARGS = ["--data_type", "voc", "--img_size", "48", "--batch_size", "4",
        "--drop_iter", "2", "--bucket_size", "32", "--attn_impl", "xla",
        "--max_txt_len", "32", "--max_att_block_num", "1",
        "--prune_att_head", "1", "--max_classes", "4"]


def _fake_voc(root):
    base = root / "VOCdevkit/VOC2012"
    (base / "ImageSets/Segmentation").mkdir(parents=True)
    (base / "JPEGImages").mkdir()
    (base / "SegmentationClass").mkdir()
    (root / "GPT4o_classification").mkdir()
    rng = np.random.RandomState(0)
    ids = [f"2007_{i:06d}" for i in range(N_IMG)]
    gpt = {}
    for img_id in ids:
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        img[:30, :40] = [200, 40, 40]
        Image.fromarray(img).save(base / "JPEGImages" / f"{img_id}.jpg")
        gt = np.zeros((H, W), np.uint8)
        gt[:30, :40] = 12
        gt[40:, 50:] = 255  # ignore -> remapped to 0
        Image.fromarray(gt).save(base / "SegmentationClass" / f"{img_id}.png")
        gpt[img_id] = "[12: 'dog', 8: 'cat'], [12: 95%, 8: 80%]"
    (base / "ImageSets/Segmentation/val.txt").write_text("\n".join(ids) + "\n")
    (root / "GPT4o_classification/voc_classification_noboundary.json") \
        .write_text(json.dumps(gpt))
    return str(root)


def _checkpoint(path):
    """A tiny LAVIS retrieval-layout .pth; every tensor random (the norms
    too, so a misplaced key shows)."""
    cfg = jcfg_mod.ModelConfig.tiny()
    rng = np.random.RandomState(11)
    sd = _tiny_torch_state_dict(cfg, rng)
    for k, v in sd.items():
        if np.all(v == 0) or np.all(v == 1):  # norms and zero biases
            sd[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    sd.update(_retrieval_checkpoint_extras(cfg, sd, rng))
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}}, path)
    return str(path)


def _tiny_build_config(real, mod):
    """``build_config`` at the tiny model widths, everything else from the
    flags (image size, text length, drop rounds)."""

    def build(args):
        cfg = real(args)
        tiny = mod.ModelConfig.tiny()
        model = dataclasses.replace(
            tiny, vit=dataclasses.replace(tiny.vit, image_size=args.img_size),
            max_text_len=args.max_txt_len)
        return dataclasses.replace(
            cfg, model=model,
            drop=dataclasses.replace(cfg.drop, patches_per_round=2))

    return build


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("HOME", str(root / "home"))
    mp.setattr(jax_cli, "build_config",
               _tiny_build_config(jax_cli.build_config, jcfg_mod))
    mp.setattr(port_cli, "build_config",
               _tiny_build_config(port_cli.build_config, pcfg_mod))
    home = _fake_voc(root / "voc")
    ckpt = _checkpoint(root / "model_retrieval.pth")
    common = ARGS + ["--home_dir", home, "--checkpoint", ckpt]
    jax_cli.main(common + ["--save_path", str(root / "jax")])
    port_cli.main(common + ["--save_path", str(root / "port"),
                            "--device", "cpu"])
    host = ["--postprocess_backend", "host"]
    jax_cli.main(common + host + ["--save_path", str(root / "jax_host")])
    port_cli.main(common + host + ["--save_path", str(root / "port_host"),
                                   "--device", "cpu"])
    yield dict(root=root, home=home, ckpt=ckpt, common=common)
    mp.undo()


def _hists(out, sub):
    d = os.path.join(out, sub)
    return {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("sub", HIST_DIRS)
def test_port_hists_match_the_jax_cli(env, sub):
    jax_h = _hists(env["root"] / "jax", sub)
    port_h = _hists(env["root"] / "port", sub)
    assert sorted(port_h) == sorted(jax_h) and len(port_h) == N_IMG
    for name, h in port_h.items():
        assert h.shape == (21, 21) and h.sum() == H * W, name
        l1 = np.abs(h.astype(np.int64) - jax_h[name]).sum()
        assert l1 <= 0.01 * H * W, (name, l1)


@pytest.mark.parametrize("sub", HIST_DIRS)
def test_host_backend_hists_match_the_jax_cli(env, sub):
    """``--postprocess_backend host``: the grid maps resized once to GT,
    blur and the native lattice CRF at GT resolution on the finalize
    worker, against the JAX CLI's parity path (``tests/test_cli.py``'s
    ``test_cli_host_parity_backend``), within the same 1% L1 bar."""
    jax_h = _hists(env["root"] / "jax_host", sub)
    port_h = _hists(env["root"] / "port_host", sub)
    assert sorted(port_h) == sorted(jax_h) and len(port_h) == N_IMG
    for name, h in port_h.items():
        assert h.shape == (21, 21) and h.sum() == H * W, name
        l1 = np.abs(h.astype(np.int64) - jax_h[name]).sum()
        assert l1 <= 0.01 * H * W, (name, l1)
    # The parity path labels other pixels than the device postprocess.
    assert any(not np.array_equal(h, _hists(env["root"] / "port", sub)[n])
               for n, h in port_h.items())


@pytest.mark.parametrize("sub", HIST_DIRS)
def test_port_run_miou_within_half_a_point(env, sub):
    names = get_dataset_meta("voc").metric_class_names()
    got = aggregate(str(env["root"] / "port"), "voc")[sub]["Mean IoU"]
    want = jax_scores(sum(_hists(env["root"] / "jax", sub).values()),
                      names)["Mean IoU"]
    assert abs(got - want) <= 0.005, (got, want)


def test_resume_writes_nothing(env):
    out = env["root"] / "port"
    paths = [out / sub / f for sub in HIST_DIRS
             for f in os.listdir(out / sub)]
    mtimes = {p: os.path.getmtime(p) for p in paths}
    summary = port_cli.main(env["common"] + ["--save_path", str(out),
                                             "--device", "cpu"])
    assert summary["images"] == 0
    assert {p: os.path.getmtime(p) for p in paths} == mtimes


def test_eval_at_bucket_totals_equal_the_files(env, tmp_path):
    out = tmp_path / "bucket"
    port_cli.main(env["common"] + ["--save_path", str(out), "--device",
                                   "cpu", "--eval_at_bucket"])
    for variant, sub in zip(("r0", "agg"), HIST_DIRS):
        files = _hists(out, sub + "_bucket32")
        assert len(files) == N_IMG
        assert all(h.dtype == np.int32 and h.sum() == 32 * 32
                   for h in files.values())
        total = np.load(out / f"total_hist_{variant}_bucket32_rank0.npy")
        np.testing.assert_array_equal(total, sum(files.values()))


def test_in_the_wild_and_viz(env, tmp_path):
    wild = tmp_path / "wild"
    wild.mkdir()
    rng = np.random.RandomState(3)
    for name in ("street", "park"):
        img = (rng.rand(50, 70, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(wild / f"{name}.jpg")
    out = tmp_path / "out"
    port_cli.main(env["common"] + [
        "--save_path", str(out), "--device", "cpu", "--in_the_wild",
        "--wild_dir", str(wild), "--wild_classes", "dog,cat"])
    port_cli.main(env["common"] + [
        "--save_path", str(out), "--device", "cpu",
        "--viz_ids", "2007_000001", "--record_classification"])
    files = set(os.listdir(out / "viz"))
    assert {"wild_street.jpeg", "wild_park.jpeg", "seg_2007_000001.jpeg",
            "gt_2007_000001.jpeg", "attn_2007_000001_dog.jpeg"} <= files
    pred = np.load(out / "classification_pred" / "img_2007_000001.npy")
    assert pred.nonzero()[0].tolist() == [7, 11]  # cat, dog


# Fixed ids keep the cases' names stable. Each case is a documented
# outcome of the parallel flags: a model axis > 1 without the ranks of
# --distributed raises, so does more than one model-axis strategy; --mesh
# alone and --distributed over one rank run and write the files of the
# plain run. ``item`` is the SystemExit's message, or None for a run.
@pytest.mark.parametrize("flags, item", [
    pytest.param(["--tensor_parallel", "2"], "--distributed",
                 id="flags1-A8"),
    pytest.param(["--sequence_parallel", "2", "--pipeline_parallel", "2"],
                 "at most one", id="flags2-A8"),
    pytest.param(["--pipeline_parallel", "2", "--pp_microbatches", "2"],
                 "--distributed", id="flags3-A8"),
    pytest.param(["--mesh"], None, id="flags4-A8"),
    pytest.param(["--distributed", "--mesh"], None, id="flags5-A8"),
])
def test_unported_flags_raise(env, tmp_path, monkeypatch, flags, item):
    args = env["common"] + ["--save_path", str(tmp_path / "out"),
                            "--device", "cpu"] + flags
    if item is not None:
        with pytest.raises(SystemExit, match=item):
            port_cli.main(args)
        assert not os.listdir(tmp_path)
        return
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    summary = port_cli.main(args)
    assert not torch.distributed.is_initialized()
    assert ("global_avg" in summary) == ("--distributed" in flags)
    for sub in HIST_DIRS:
        got, want = _hists(tmp_path / "out", sub), _hists(
            env["root"] / "port", sub)
        assert sorted(got) == sorted(want) and len(got) == N_IMG
        for name in got:
            np.testing.assert_array_equal(got[name], want[name])


def test_cuda_without_a_card_raises(env, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(env["common"] + ["--save_path", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_trace_spans_writes_a_chrome_trace(env, tmp_path):
    """``--trace_spans PATH``: the runner's spans of every batch as complete
    events (rank as pid, thread as tid, batch id in args) and its counters,
    written at exit; the tracer is off again after the run."""
    from pnp_ovss_tpu_torch.utils.tracing import TRACER

    path = tmp_path / "spans.json"
    port_cli.main(env["common"] + ["--save_path", str(tmp_path / "out"),
                                   "--device", "cpu", "--no_resume",
                                   "--trace_spans", str(path)])
    assert not TRACER.enabled
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    counters = {e["name"]: e["args"][e["name"]] for e in events
                if e["ph"] == "C"}
    batches = -(-N_IMG // 4)
    assert counters["runner.batches"] == batches
    assert counters["runner.images"] == 4 * batches  # the tail is padded
    submits = [e for e in spans if e["name"] == "runner.submit"]
    results = [e for e in spans if e["name"] == "runner.result"]
    assert len(submits) == len(results) == batches
    assert sorted(e["args"]["batch"] for e in submits) == \
        sorted(e["args"]["batch"] for e in results)
    assert {e["pid"] for e in spans} == {0}
    assert all(e["dur"] >= 0 and isinstance(e["tid"], int) for e in spans)
    names = {e["name"] for e in spans}
    assert {"runner.upload", "drop.round", "vit.encode", "bert.gradcam",
            "drop.select", "runner.maps", "runner.post", "post.blur",
            "post.crf"} <= names
