"""The comparison has to refuse: the control (the reference one step below
each stated precision, in the system's place), and a run whose timed path
is broken underneath. All on the CPU at test widths, the harness's look
for a card skipped."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from port_bench import check, harness, traffic as traffic_mod
from port_bench.reference.precision import Rounding
from port_bench.tests import tiny

LIMITS = json.loads((tiny.DATA / "tiny_limits.json").read_text())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_is_not_correct(tmp_path, seed):
    root = tiny.make_root(tmp_path, LIMITS)
    p = harness.plan(tiny.CELL, root, root / "port_bench")
    cfg, pipe, traffic = p["config"], p["pipeline"], p["traffic"]
    pool = traffic_mod.make_pool(
        traffic, batch=pipe["batch_size"],
        image_size=cfg["model"]["vit"]["image_size"],
        bucket=pipe["bucket"], seed=seed, device="cpu")
    vocab = traffic_mod.vocab(traffic)
    recs = check.control_records(cfg, pipe, pool, vocab, [0, 1, 2, 3], seed,
                                 "cpu", Rounding.lower_than(p["precision"]))
    nums = check.judge(cfg, pipe, p["precision"], pool, vocab, recs, seed,
                       "cpu")
    checks = check.verdict(nums, LIMITS)
    assert not check.passed(checks), checks


def _runner_mod():
    from pnp_ovss_tpu_torch.pipeline import runner

    return runner


def fault_state_unchanged(monkeypatch):
    """The drop step hands its state on unchanged."""
    from pnp_ovss_tpu_torch.pipeline import drop

    real = drop.make_split_round_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def unchanged(dropped, images, ids, mask):
            _, gc = step(dropped, images, ids, mask)
            return dropped, gc
        return unchanged

    monkeypatch.setattr(drop, "make_split_round_step", make)


def fault_half_batch(monkeypatch):
    """GradCAM computed for the first half of the batch; the rest get the
    mean of those."""
    runner = _runner_mod()
    real = runner.gradcam_from_embeds

    def half(model, embeds, ids, mask, **kw):
        n = max(1, embeds.shape[0] // 2)
        gc, logits = real(model, embeds[:n], ids[:n], mask[:n], **kw)
        rest = gc.mean(1, keepdim=True).expand(
            -1, embeds.shape[0] - n, *gc.shape[2:])
        return torch.cat([gc, rest], 1), torch.cat(
            [logits, logits.mean(0, keepdim=True).expand(
                embeds.shape[0] - n, -1)])

    monkeypatch.setattr(runner, "gradcam_from_embeds", half)


def fault_labels_altered(monkeypatch):
    """Each label moves to the next channel where it is produced."""
    runner = _runner_mod()
    real = runner.SegmentationRunner._post

    def shifted(self, *a, **kw):
        labels = real(self, *a, **kw)
        return ((labels.long() + 1) % (self.cfg.max_classes + 1)) \
            .to(labels.dtype)

    monkeypatch.setattr(runner.SegmentationRunner, "_post", shifted)


@pytest.mark.parametrize("fault", [fault_state_unchanged, fault_half_batch,
                                   fault_labels_altered],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res, _ = tiny.run(tmp_path, seed=4, limits=LIMITS)
    assert res["correct"] is False, res["checks"]


def test_without_a_card_run_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(tiny.BENCH / "run.py"), "--workload",
         "blip_l336.voc", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pnp_ovss_tpu_torch_extra",
                        types.ModuleType("pnp_ovss_tpu_torch_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pnp_ovss_tpu.models",
                        types.ModuleType("pnp_ovss_tpu.models"))
    assert harness.forbidden_modules() == ["pnp_ovss_tpu"]
