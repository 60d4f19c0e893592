"""Process groups (counterpart of ``pnp_ovss_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` device mesh. The
port runs one process per rank and joins them with ``torch.distributed``.
This slice takes data = 1 x model = sp, the JAX package's
``make_mesh_2d(sp, devices[:sp])`` for the sequence-parallel encode: every
rank is a member of the model axis, and that axis's group carries the
encode's K/V and token gathers. Data parallelism (data > 1) and the
Megatron and pipeline partition specs of tensor and pipeline parallelism
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def backend_for(devices: Sequence) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``: CPU
    tensors, and ranks that share one card (NCCL refuses two ranks on one
    device). ``devices[r]`` is rank r's device."""
    devs = [torch.device(d) for d in devices]
    cards = {d.index or 0 for d in devs if d.type == "cuda"}
    return "nccl" if len(cards) == len(devs) else "gloo"


@dataclasses.dataclass(frozen=True)
class SequenceGroup:
    """The model axis of a data = 1 x model = sp mesh: its process group,
    its size and this process's rank in it."""

    group: dist.ProcessGroup
    size: int
    rank: int

    def all_gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``[B, s, ...]`` chunk, concatenated on dim 1 in
        rank order (= token order). gloo gathers CUDA tensors itself
        (PyTorch 2.11 on an H100), so ranks that share one card gather
        on it as NCCL ranks do."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=1)


def make_mesh_2d(model_parallel: int, devices: Sequence, *, rank: int,
                 init_method: str) -> SequenceGroup:
    """Join ``len(devices)`` processes, rank r computing on ``devices[r]``
    (the same list on every rank), into a (data, model) mesh with
    ``model_parallel`` ranks on the model axis, and return this rank's
    sequence group. ``init_method`` is the rendezvous
    (``tcp://localhost:<port>`` or ``file://<path>``); the caller ends the
    group with ``torch.distributed.destroy_process_group()``."""
    n = len(devices)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by "
                         f"model_parallel={model_parallel}")
    if n // model_parallel > 1:
        raise NotImplementedError(
            f"data = {n // model_parallel} > 1: data parallelism is not "
            "ported yet; the port takes data = 1 x model = sp")
    dev = torch.device(devices[rank])
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(devices), init_method=init_method,
                            rank=rank, world_size=n)
    return SequenceGroup(group=dist.group.WORLD, size=n, rank=rank)
