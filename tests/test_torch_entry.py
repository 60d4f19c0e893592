"""The port's entry points (``pnp_ovss_tpu_torch/entry.py``), mirroring
``tests/test_graft_entry.py``: the multi-rank dry run over four spawned
gloo CPU ranks (data 2 x model 2: the tiny pipeline under tensor
parallelism, then sequence- and pipeline-parallel legs on the fused
config), and the flagship GradCAM step at a tiny width with the full
model's image size, so its output has the full model's grid."""

import dataclasses

import numpy as np
import pytest
import torch

from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch import entry as port_entry


def test_dryrun_multichip_4_ranks_on_the_cpu(capfd):
    port_entry.dryrun_multichip(4, device="cpu", timeout_s=300)
    assert "dryrun_multichip OK: 4 ranks (gloo, data=2 x model=2)" in \
        capfd.readouterr().out


def test_dryrun_needs_pairs_of_ranks():
    with pytest.raises(ValueError, match="even"):
        port_entry.dryrun_multichip(3, device="cpu")


def test_entry_gradcam_step_shapes():
    """BLIP-ITM-Large's topology at 336 px (grid 21) with tiny widths:
    BERT of 9 layers (a last-layer GradCAM is structurally zero) and 12
    heads, so that layer 8, head 9 exist."""
    tiny = pcfg_mod.ModelConfig.tiny()
    cfg = dataclasses.replace(
        tiny, vit=dataclasses.replace(tiny.vit, image_size=336),
        bert=dataclasses.replace(tiny.bert, num_layers=9, num_heads=12,
                                 hidden_size=48))
    fn, args = port_entry.entry(device="cpu", cfg=cfg)
    gc, logits = fn(*args)
    b, t = args[1].shape
    assert gc.shape == (b, t - 1, 21, 21) and b == args[0].shape[0] == 2
    assert logits.shape == (b, 2)
    assert torch.isfinite(gc).all() and (gc >= 0).all()
    assert np.abs(gc.numpy()).sum() > 0
