"""Megatron tensor parallelism over the model axis of a process mesh.

The JAX package has no such module: it places each leaf by its partition
spec (``parallel/mesh.py``) and GSPMD inserts the collectives. The port
does both by hand:

- ``shard_model`` keeps, in every column- and row-parallel ``nn.Linear``
  of the Megatron table, only this rank's slab of the weight (and of a
  column-parallel bias); the modules' forwards (``models/vit.py``,
  ``models/bert.py``) then run on this rank's heads and features;
- ``copy_to_model_group`` and ``reduce_from_model_group`` are Megatron's
  f and g: f is the identity forward and all-reduces the gradient, g
  all-reduces the forward and passes the gradient through. A column slab
  reads f's output, a row slab's partial product goes through g, so the
  GradCAM backward through BERT sums each replicated activation's
  gradient over the ranks;
- ``gather_heads`` assembles a ``[B, H/tp, ...]`` tensor of this rank's
  heads into ``[B, H, ...]`` in rank order; its backward takes this
  rank's slice.

All collectives run on the calling (main) thread. Under gloo the tensors
may lie on a card: gloo's all-reduce and all-gather take CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import distributed as dist
from torch import nn

from pnp_ovss_tpu_torch.parallel.mesh import (
    AxisGroup, ProcessMesh, _leaf_spec,
)


def _all_reduce(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=axis.group)
    return x


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        h = grad.shape[1] // ctx.axis.size
        return grad[:, ctx.axis.rank * h:(ctx.axis.rank + 1) * h], None


def copy_to_model_group(x: torch.Tensor,
                        axis: Optional[AxisGroup]) -> torch.Tensor:
    """Megatron's f: identity forward, gradient all-reduced backward."""
    if axis is None or axis.size == 1:
        return x
    return _CopyToModelGroup.apply(x, axis)


def reduce_from_model_group(x: torch.Tensor,
                            axis: Optional[AxisGroup]) -> torch.Tensor:
    """Megatron's g: the partial sums all-reduced forward, the gradient
    passed through backward."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromModelGroup.apply(x, axis)


def gather_heads(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """[B, H/tp, ...] of this rank's heads -> [B, H, ...], rank r's heads
    at [r * H/tp, (r + 1) * H/tp)."""
    if axis is None or axis.size == 1:
        return x
    return _GatherHeads.apply(x, axis)


class _RowPartialBF16(torch.autograd.Function):
    """bf16 operands on the tensor cores with an f32 result (``mm`` with
    ``out_dtype``, which has no derivative of its own)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.T,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g @ w.float()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (g.T @ x.reshape(-1, x.shape[-1]).float()).to(w.dtype)
        return dx, dw


def row_partial(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """This rank's f32 partial product of a row-parallel ``linear``
    (no bias: it is added once, after the sum): the compute dtype's
    values multiplied and summed in f32, so the sum over ranks rounds
    once, as the unsharded product does. bf16 on the card takes the
    tensor cores with an f32 result (no f32 copy of the weight); otherwise
    the product is taken in f32, where the products of bf16 values are
    exact."""
    w = linear.weight
    if x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16:
        return _RowPartialBF16.apply(x, w)
    return x.float() @ w.float().T


def check_heads(num_heads: int, tp: int, what: str) -> int:
    """This rank's head count; ``tp`` must divide ``num_heads``."""
    if num_heads % tp:
        ok = [t for t in range(1, num_heads + 1) if num_heads % t == 0]
        raise ValueError(f"tensor parallelism {tp} does not divide the "
                         f"{what}'s {num_heads} heads (want tp in {ok})")
    return num_heads // tp


def shard_model(model: nn.Module, mesh: ProcessMesh) -> nn.Module:
    """Keep, in place, only this rank's slab of every column- and
    row-parallel ``nn.Linear`` of ``model`` (a ``BlipITM``, or any module
    whose parameter names follow the port's: ``from_jax_params`` maps the
    JAX paths to them segment for segment), and set ``model.tp`` to the
    mesh's model axis. ``tp`` must divide the ViT's and BERT's head
    counts. A slab is cut on the device its weight lies on, and the
    whole weight is dropped, so a model moved to the card afterwards
    holds only the slabs there."""
    axis = mesh.model_axis
    tp = axis.size
    cfg = model.cfg  # a ModelConfig, or a ViTConfig / BertConfig
    for what, sub in (("ViT", "vit"), ("BERT", "bert"), ("model", None)):
        c = cfg if sub is None else getattr(cfg, sub, None)
        if hasattr(c, "num_heads"):
            check_heads(c.num_heads, tp, what)
    model.tp = axis if tp > 1 else None
    if tp == 1:
        return model
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        path = name.replace(".", "/")
        # The JAX layout: kernel [in, out] is the transpose of the weight.
        ax = _leaf_spec(f"{path}/kernel", tuple(mod.weight.shape[::-1]), tp)
        if ax is None:
            continue
        dim = 1 - ax  # kernel axis 1 (out) is the weight's dim 0
        n = mod.weight.shape[dim] // tp
        sl = slice(axis.rank * n, (axis.rank + 1) * n)
        with torch.no_grad():
            w = mod.weight[sl] if dim == 0 else mod.weight[:, sl]
            mod.weight = nn.Parameter(w.contiguous(),
                                      requires_grad=mod.weight.requires_grad)
            if dim == 0 and mod.bias is not None:
                mod.bias = nn.Parameter(mod.bias[sl].contiguous(),
                                        requires_grad=mod.bias.requires_grad)
        if dim == 0:
            mod.out_features = n
        else:
            mod.in_features = n
    return model
