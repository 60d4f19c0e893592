"""Process meshes and the Megatron layout (counterpart of
``pnp_ovss_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` device mesh. The
port runs one process per rank, as the reference's DDP does (one process
per GPU, a process group, a DistributedSampler), and joins the ranks with
``torch.distributed``. Global rank ``r = d * model + m``: ``d`` is the
rank's index on the ``data`` axis, ``m`` on the ``model`` axis (innermost,
as in the JAX mesh). Each rank belongs to one data group (the ranks with
its ``m``: they hold different records and reduce the run's totals) and
one model group (the ranks with its ``d``: they work on the same batch,
and the model axis carries tensor parallelism's partial sums, sequence
parallelism's K/V gathers or pipeline parallelism's stage hand-offs).

The Megatron table below is the JAX package's, applied to the same
'/'-joined leaf paths: ``param_partition_specs`` reads a JAX-layout tree
and gives each leaf the axis the JAX spec shards, and
``parallel.tensor.shard_model`` reads the port's modules through the same
paths.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Megatron rules on '/'-joined leaf paths (JAX mesh.py:42-47). Column:
# output features split (a kernel's last axis and its bias); row: input
# features split (the kernel's second-to-last axis; the bias is added once,
# after the sum). Everything else, the ViT's fused qkv included, is
# replicated.
COLUMN_PARALLEL = ("query", "key", "value", "intermediate", "mlp_fc1")
ROW_PARALLEL = ("output_dense", "attn/proj", "mlp_fc2")

# How long a collective may wait for a peer before the process group
# raises, so that a rank that failed between collectives cannot hang the
# others forever.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(devices: Sequence) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``: CPU
    tensors, and ranks that share one card (NCCL refuses two ranks on one
    device). ``devices[r]`` is rank r's device."""
    devs = [torch.device(d) for d in devices]
    cards = {d.index or 0 for d in devs if d.type == "cuda"}
    return "nccl" if len(cards) == len(devs) else "gloo"


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One axis of a mesh as this rank sees it: its process group, its
    size and this rank's index on it."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int

    def global_rank(self, index: int) -> int:
        """The global rank of the member at ``index`` on this axis."""
        return dist.get_global_rank(self.group, index)

    def all_gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``[B, s, ...]`` chunk, concatenated on dim 1 in
        rank order (= token order). gloo gathers CUDA tensors itself
        (PyTorch 2.11 on an H100), so ranks that share one card gather
        on it as NCCL ranks do."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=1)


# The sequence-parallel encode's view of the model axis.
SequenceGroup = AxisGroup


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in a (data, model) mesh of processes."""

    world_size: int
    rank: int
    data: int
    model: int
    backend: str
    data_axis: AxisGroup
    model_axis: AxisGroup

    @property
    def data_rank(self) -> int:
        return self.data_axis.rank

    @property
    def model_rank(self) -> int:
        return self.model_axis.rank


def _axis_groups(n: int, model: int, rank: int):
    """Every data group and every model group, created in one order on
    every rank (``dist.new_group`` must be called by all ranks for every
    group, also those it is not in). Returns (data_axis, model_axis)."""
    data = n // model
    d, m = divmod(rank, model)
    world = dist.group.WORLD
    if model == n:
        model_group = world
    else:
        model_group = None
        for dd in range(data):
            g = dist.new_group([dd * model + mm for mm in range(model)])
            if dd == d:
                model_group = g
    if data == n:
        data_group = world
    else:
        data_group = None
        for mm in range(model):
            g = dist.new_group([dd * model + mm for dd in range(data)])
            if mm == m:
                data_group = g
    return (AxisGroup(data_group, data, d), AxisGroup(model_group, model, m))


def _join(model_parallel: int, n: int, rank: int, backend: str,
          init_method: Optional[str], timeout) -> ProcessMesh:
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by "
                         f"model_parallel={model_parallel}")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=n, timeout=timeout)
    data_axis, model_axis = _axis_groups(n, model_parallel, rank)
    return ProcessMesh(world_size=n, rank=rank, data=n // model_parallel,
                       model=model_parallel, backend=dist.get_backend(),
                       data_axis=data_axis, model_axis=model_axis)


def _set_device(device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)


def make_mesh_2d(model_parallel: int, devices: Sequence, *, rank: int,
                 init_method: str,
                 timeout: datetime.timedelta = DEFAULT_TIMEOUT
                 ) -> ProcessMesh:
    """Join ``len(devices)`` processes, rank r computing on ``devices[r]``
    (the same list on every rank), into a (data, model) mesh with
    ``model_parallel`` ranks on the model axis and ``len(devices) /
    model_parallel`` on the data axis. ``init_method`` is the rendezvous
    (``tcp://localhost:<port>`` or ``file://<path>``); the caller ends the
    mesh with ``torch.distributed.destroy_process_group()``."""
    _set_device(devices[rank])
    return _join(model_parallel, len(devices), rank, backend_for(devices),
                 init_method, timeout)


def make_mesh(devices: Sequence, *, rank: int,
              init_method: str) -> ProcessMesh:
    """The data-only mesh over ``len(devices)`` processes (the
    reference's DDP layout: every rank holds the whole model)."""
    return make_mesh_2d(1, devices, rank=rank, init_method=init_method)


def init_from_env(model_parallel: int = 1, device="cuda") -> tuple:
    """Join the ranks torchrun started (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
    ``device``: "cuda" computes on ``cuda:{LOCAL_RANK}`` (NCCL when every
    rank of the host has its own card, which torchrun's one process per
    card gives); "cuda:N" pins every rank to card N and "cpu" to the CPU
    (both gloo). Returns (mesh, this rank's device)."""
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, and there is no "
                               "CUDA card")
        dev = torch.device("cuda", local)
        backend = "nccl"
    else:
        backend = "gloo"
    _set_device(dev)
    return (_join(model_parallel, n, rank, backend, "env://",
                  DEFAULT_TIMEOUT), dev)


def free_port() -> int:
    """A free TCP port on localhost, for a ``tcp://localhost:<port>``
    rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn(fn: Callable, nprocs: int, args: tuple = (), *,
          timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started with the
    spawn start method (``fn`` importable at a module's top level). Raises
    when a process fails (the others are ended) or when the processes
    have not all ended ``timeout_s`` seconds after the start (then all
    are killed): a rank that died between collectives cannot hang the
    caller."""
    from torch import multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _path_matches(parts: Sequence[str], rule: str) -> bool:
    """True iff ``rule`` (one or more '/'-joined names) appears as a
    consecutive run of whole path segments (JAX mesh.py:78-89): a module
    named ``key_pool`` does not inherit ``key``'s split."""
    rp = rule.split("/")
    return any(list(parts[i:i + len(rp)]) == rp
               for i in range(len(parts) - len(rp) + 1))


def _leaf_spec(path: str, shape, tp: int) -> Optional[int]:
    """The axis of a JAX-layout leaf (kernel ``[..., in, out]``, bias
    ``[..., out]``) that ``tp``-way model sharding splits, or None for a
    replicated leaf (JAX mesh.py:92-111; an indivisible axis is
    replicated)."""

    def axis(from_end: int) -> Optional[int]:
        ax = len(shape) - from_end
        return None if shape[ax] % tp else ax

    parts = path.split("/")
    leaf = parts[-1]
    if any(_path_matches(parts, r) for r in COLUMN_PARALLEL) and \
            leaf in ("kernel", "bias"):
        return axis(1)
    if any(_path_matches(parts, r) for r in ROW_PARALLEL) and \
            leaf == "kernel":
        return axis(2)
    return None


def _leaves(tree, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(val, "items"):
            yield from _leaves(val, path)
        else:
            yield path, val


def param_partition_specs(params, model_parallel: int
                          ) -> Dict[str, Optional[int]]:
    """{'/'-joined leaf path: split axis or None} of a JAX-layout
    parameter tree (nested mappings of arrays) under ``model_parallel``-way
    Megatron sharding, leaf for leaf the JAX ``param_partition_specs``."""
    return {path: (None if model_parallel <= 1
                   else _leaf_spec(path, tuple(leaf.shape), model_parallel))
            for path, leaf in _leaves(params)}
