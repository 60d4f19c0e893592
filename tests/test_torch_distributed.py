"""The port's data parallelism over spawned ranks (the counterpart of
``tests/test_distributed.py`` and ``tests/_dist_child.py``).

Two gloo CPU ranks (one spawn for the module, ``tests/test_torch_sp_ranks.py``)
check the reference's DDP contract the way the port keeps it: records
split on the DistributedSampler's stride, a confusion-matrix total
all-reduced over the data group equal to the host sum on both ranks, and
``MetricLogger``'s synchronised global average equal on both ranks. Then
the segmentation CLI runs with ``--distributed --mesh --eval_at_bucket
--device cpu`` on the two ranks over ``tests/test_torch_cli.py``'s tiny
fake VOC and checkpoint (``build_config`` patched to the tiny widths in
each rank, as that file patches it in its process), against the
single-process port CLI on the same flags: equal per-image hists, each
rank's total the sum of all of them.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.cli import segment as port_cli
from test_torch_sp_ranks import run_ranks

N_CLASS, HW = 5, 16
CLI_ARGS = ["--data_type", "voc", "--img_size", "48", "--batch_size", "4",
            "--drop_iter", "2", "--bucket_size", "32", "--attn_impl", "xla",
            "--max_txt_len", "32", "--max_att_block_num", "1",
            "--prune_att_head", "1", "--max_classes", "4",
            "--device", "cpu", "--eval_at_bucket"]
HIST_DIRS = ("hist_withfiltered_caption_bucket32",
             "all_drop_hist_with_filtered_caption_bucket32")


_REAL_BUILD = port_cli.build_config


def _tiny_build_config(args):
    """The CLI's ``build_config`` at the tiny model widths (as
    tests/test_torch_cli.py patches it)."""
    cfg = _REAL_BUILD(args)
    tiny = pcfg_mod.ModelConfig.tiny()
    model = dataclasses.replace(
        tiny, vit=dataclasses.replace(tiny.vit, image_size=args.img_size),
        max_text_len=args.max_txt_len)
    return dataclasses.replace(
        cfg, model=model,
        drop=dataclasses.replace(cfg.drop, patches_per_round=2))


# --- rank functions -----------------------------------------------------


def rank_contract(mesh):
    """Strided records, an all-reduced hist total, a synchronised
    metric."""
    from torch import distributed as dist

    from pnp_ovss_tpu_torch.data.datasets import shard_records
    from pnp_ovss_tpu_torch.evalx.metrics import batch_hist_t
    from pnp_ovss_tpu_torch.utils.logging import MetricLogger

    r, n = mesh.data_rank, mesh.data
    records = shard_records(list(range(11)), r, n)
    rng = np.random.RandomState(7)
    gt = rng.randint(0, N_CLASS, (2 * n, HW, HW))
    pred = rng.randint(0, N_CLASS, (2 * n, HW, HW))
    mine = slice(2 * r, 2 * r + 2)
    total = batch_hist_t(torch.from_numpy(gt[mine]),
                         torch.from_numpy(pred[mine]), N_CLASS).sum(0)
    dist.all_reduce(total, group=mesh.data_axis.group)
    logger = MetricLogger()
    for _ in range(r + 1):
        logger.update(imgs_per_s=10.0 * (r + 1))
    logger.synchronize_between_processes()
    m = logger.meters["imgs_per_s"]
    return dict(records=records, total=total.numpy(), count=m.count,
                global_avg=m.global_avg)


def rank_cli(mesh, argv):
    """The CLI under ``--distributed`` in this rank (torchrun's env: the
    rank joins the world this process already belongs to)."""
    os.environ.update(RANK=str(mesh.rank), WORLD_SIZE=str(mesh.world_size),
                      LOCAL_RANK=str(mesh.rank))
    port_cli.build_config = _tiny_build_config  # this rank's process only
    return port_cli.main(argv)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_cli import _checkpoint, _fake_voc

    root = tmp_path_factory.mktemp("dist")
    mp = pytest.MonkeyPatch()
    mp.setenv("HOME", str(root / "home"))
    home = _fake_voc(root / "voc")
    ckpt = _checkpoint(root / "model_retrieval.pth")
    common = CLI_ARGS + ["--home_dir", home, "--checkpoint", ckpt]
    mp.setattr(port_cli, "build_config", _tiny_build_config)
    single = port_cli.main(common + ["--save_path", str(root / "single")])
    argv = common + ["--save_path", str(root / "dp"), "--distributed",
                     "--mesh"]
    outs = run_ranks({"contract": ("call", rank_contract),
                      "cli": ("call", rank_cli, argv)}, ["cpu"] * 2,
                     root, model_parallel=1)
    yield outs, root, single
    mp.undo()


def test_records_follow_the_sampler_stride(ranks):
    outs, _, _ = ranks
    for r, out in enumerate(outs):
        assert out["contract"]["records"] == list(range(11))[r::2]


def test_total_is_all_reduced_on_both_ranks(ranks):
    """Each rank counts its two images; after the data group's
    all-reduce both hold the host sum of all four."""
    from pnp_ovss_tpu_torch.evalx.metrics import fast_hist

    outs, _, _ = ranks
    rng = np.random.RandomState(7)
    gt = rng.randint(0, N_CLASS, (4, HW, HW))
    pred = rng.randint(0, N_CLASS, (4, HW, HW))
    want = sum(fast_hist(t.flatten(), p.flatten(), N_CLASS)
               for t, p in zip(gt, pred))
    for out in outs:
        np.testing.assert_array_equal(out["contract"]["total"], want)


def test_metric_sync_gives_one_global_avg(ranks):
    """Rank r adds r + 1 samples of 10 (r + 1); both ranks report the
    global count 3 and average (10 + 40) / 3."""
    outs, _, _ = ranks
    for out in outs:
        assert out["contract"]["count"] == 3
        assert abs(out["contract"]["global_avg"] - 50.0 / 3) < 1e-9


def test_cli_ranks_equal_the_single_process_cli(ranks):
    """Images 0, 2, 4 on rank 0 and 1, 3 on rank 1; every per-image hist
    equal to the single-process run's; each rank's total file is the
    whole run's total, equal to the single-process total and to the sum
    of the per-image files; both ranks log one synchronised average."""
    outs, root, single = ranks
    assert [out["cli"]["images"] for out in outs] == [3, 2]
    assert single["images"] == 5
    for variant, sub in zip(("r0", "agg"), HIST_DIRS):
        files = sorted(os.listdir(root / "dp" / sub))
        assert files == sorted(os.listdir(root / "single" / sub))
        assert len(files) == 5
        hists = {f: np.load(root / "dp" / sub / f) for f in files}
        for f, h in hists.items():
            np.testing.assert_array_equal(h, np.load(root / "single" / sub
                                                     / f))
        want = np.load(root / "single"
                       / f"total_hist_{variant}_bucket32_rank0.npy")
        np.testing.assert_array_equal(want, sum(hists.values()))
        for r in range(2):
            np.testing.assert_array_equal(
                np.load(root / "dp"
                        / f"total_hist_{variant}_bucket32_rank{r}.npy"),
                want)
    avgs = [out["cli"]["global_avg"] for out in outs]
    assert avgs[0] == avgs[1] and avgs[0]["imgs_per_s"] > 0
