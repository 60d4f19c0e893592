"""Ranks of a process mesh for the port's tests, one spawned process each,
and the backend choice that joins them.

``run_ranks(tasks, devices, tmp, model_parallel=None)`` saves ``tasks``
(picklable, modules included) under ``tmp``, starts one process per entry
of ``devices`` with the spawn start method, joins them into a (data,
model) mesh with ``model_parallel`` ranks on the model axis (default all:
data = 1; ``parallel.mesh.make_mesh_2d``; a ``FileStore`` under ``tmp``,
so that concurrent test workers never share a rendezvous) and returns each
rank's outputs. A task is ``("encode", vit, images)``, the
sequence-parallel encode over the model axis, ``("run", cfg, model,
bucket, batch, gt_sizes)``, one batch of
``SegmentationRunner(encode_parallel="sp")`` with ``return_maps``, or
``("call", fn, *args)``, ``fn(mesh, *args)`` for a function at the top
level of a test module; each rank's outputs also hold its kernel launches
(``"launches"``). The ranks are killed, and the test fails, when they
outlast ``RANK_TIMEOUT_S``. This module imports neither JAX nor the JAX
package, so the ranks stay light.
"""

from __future__ import annotations

import datetime
import os

import pytest
import torch
from torch import distributed as dist

from pnp_ovss_tpu_torch.parallel.mesh import backend_for, spawn

RANK_TIMEOUT_S = 240


def _rank_main(rank: int, devices, tmp: str, model_parallel: int) -> None:
    from pnp_ovss_tpu_torch.ops import _build
    from pnp_ovss_tpu_torch.parallel.mesh import make_mesh_2d
    from pnp_ovss_tpu_torch.parallel.sequence import encode_images_sp
    from pnp_ovss_tpu_torch.pipeline.runner import SegmentationRunner

    torch.set_num_threads(1)
    mesh = make_mesh_2d(model_parallel, devices, rank=rank,
                        init_method=f"file://{os.path.join(tmp, 'store')}",
                        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        tasks = torch.load(os.path.join(tmp, "tasks.pt"), weights_only=False)
        out = {}
        for name, (kind, *args) in tasks.items():
            if kind == "encode":
                vit, images = args
                out[name] = encode_images_sp(vit, images,
                                             mesh.model_axis).cpu()
            elif kind == "call":
                fn, *fargs = args
                out[name] = fn(mesh, *fargs)
            else:
                cfg, model, bucket, batch, gt = args
                runner = SegmentationRunner(
                    cfg, model, device=devices[rank], bucket_size=bucket,
                    encode_parallel="sp", mesh=mesh)
                out[name] = runner.run_batch(*batch, return_maps=True,
                                             gt_sizes=gt)
        out["launches"] = dict(_build.LAUNCHES)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tasks: dict, devices, tmp, model_parallel=None) -> list:
    """Each rank's {task name: output}, in rank order."""
    tmp = str(tmp)
    torch.save(tasks, os.path.join(tmp, "tasks.pt"))
    mp_size = len(devices) if model_parallel is None else model_parallel
    spawn(_rank_main, len(devices), (list(devices), tmp, mp_size),
          timeout_s=RANK_TIMEOUT_S)
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
