"""Number formats for the reference and for its lower-precision control.

A configuration states, for each stage of the pipeline, the format its
products or stored values are computed in (``"precision"`` in its file).
The reference itself computes every stage in float32. The control
computes each stage one step below the stated format (``LOWER``): the
step a later change could be tempted to take.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

# The next format down, as the comparison's control takes it.
LOWER = {
    "float32": "tf32",  # a float32 product with TF32 off
    "bfloat16": "float8_e4m3fn",
    "uint8": "uint4",  # stored kernel codes: 255 levels -> 15
}

_E4M3_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to the format's largest value)."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, _E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


ROUND: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": lambda x: x.float(),
    "tf32": _tf32,
    "bfloat16": lambda x: x.to(torch.bfloat16).float(),
    "float8_e4m3fn": _e4m3,
}

# Stored kernel codes in [0, 1]: levels of the unit interval.
CODE_LEVELS = {"uint8": 255, "uint4": 15}


def straight_through(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` in the forward pass, the identity in the backward pass."""
    if not x.requires_grad:
        return fn(x)
    return x + (fn(x) - x).detach()


@dataclasses.dataclass(frozen=True)
class Rounding:
    """Per-stage formats: ``None`` for a stage computes it in float32.

    - ``model``: every product operand of the ViT and the BERT encoder;
    - ``finishing``: the pooling product and the upsample products;
    - ``blur``: the blur's band matrices and maps;
    - ``crf_kernel``: the bilateral kernel (``uint8`` / ``uint4`` codes,
      or a float format);
    - ``crf_state``: the mean-field state and values that enter products.
    """

    model: Optional[str] = None
    finishing: Optional[str] = None
    blur: Optional[str] = None
    crf_kernel: Optional[str] = None
    crf_state: Optional[str] = None

    @classmethod
    def lower_than(cls, stated: Dict[str, str]) -> "Rounding":
        """The control: each stage one step below the configuration's."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(stated) - fields
        if unknown:
            raise ValueError(f"unknown precision stages {sorted(unknown)}")
        return cls(**{k: LOWER[v] for k, v in stated.items()})

    def round(self, stage: str, x: torch.Tensor) -> torch.Tensor:
        fmt = getattr(self, stage)
        if fmt is None:
            return x
        return straight_through(ROUND[fmt], x)

    def kernel(self, k: torch.Tensor) -> torch.Tensor:
        """The bilateral kernel as stored: codes or a float format."""
        fmt = self.crf_kernel
        if fmt is None:
            return k
        if fmt in CODE_LEVELS:
            levels = CODE_LEVELS[fmt]
            return torch.round(k * levels) / levels
        return ROUND[fmt](k)


EXACT = Rounding()
