"""Ranks of a sequence group for the port's tests, one spawned process each,
and the backend choice that joins them.

``run_ranks(tasks, devices, tmp)`` saves ``tasks`` (picklable, modules
included) under ``tmp``, starts one process per entry of ``devices`` with
the spawn start method, joins them into a data = 1 x model = sp mesh
(``parallel.mesh.make_mesh_2d``; a ``FileStore`` under ``tmp``, so that
concurrent test workers never share a rendezvous) and returns each rank's
outputs. A task is ``("encode", vit, images)``, the sequence-parallel
encode, or ``("run", cfg, model, bucket, batch, gt_sizes)``, one batch of
``SegmentationRunner(encode_parallel="sp")`` with ``return_maps``; each
rank's outputs also hold its kernel launches (``"launches"``). This module
imports neither JAX nor the JAX package, so the ranks stay light.
"""

from __future__ import annotations

import os

import pytest
import torch
from torch import distributed as dist
from torch import multiprocessing as mp

from pnp_ovss_tpu_torch.parallel.mesh import backend_for


def _rank_main(rank: int, devices, tmp: str) -> None:
    from pnp_ovss_tpu_torch.ops import _build
    from pnp_ovss_tpu_torch.parallel.mesh import make_mesh_2d
    from pnp_ovss_tpu_torch.parallel.sequence import encode_images_sp
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    torch.set_num_threads(1)
    sp = make_mesh_2d(len(devices), devices, rank=rank,
                      init_method=f"file://{os.path.join(tmp, 'store')}")
    try:
        tasks = torch.load(os.path.join(tmp, "tasks.pt"), weights_only=False)
        out = {}
        for name, (kind, *args) in tasks.items():
            if kind == "encode":
                vit, images = args
                out[name] = encode_images_sp(vit, images, sp).cpu()
            else:
                cfg, model, bucket, batch, gt = args
                runner = SegmentationRunner(
                    cfg, model, device=devices[rank], bucket_size=bucket,
                    encode_parallel="sp", sp_group=sp)
                out[name] = runner.run_batch(*batch, return_maps=True,
                                             gt_sizes=gt)
        out["launches"] = dict(_build.LAUNCHES)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tasks: dict, devices, tmp) -> list:
    """Each rank's {task name: output}, in rank order."""
    tmp = str(tmp)
    torch.save(tasks, os.path.join(tmp, "tasks.pt"))
    mp.start_processes(_rank_main, args=(list(devices), tmp),
                       nprocs=len(devices), start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(devices))]


@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], "gloo"), (["cuda", "cuda"], "gloo"),
    (["cuda:0", "cuda:0"], "gloo"), (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cpu"], "gloo")])
def test_backend_for(devices, want):
    """nccl only when every rank has a card of its own (it refuses two
    ranks on one device); gloo for CPU ranks and shared cards."""
    assert backend_for(devices) == want
