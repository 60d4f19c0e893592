"""PnP-OVSS on PyTorch and CUDA (NVIDIA Hopper).

A port of ``pnp_ovss_tpu`` (JAX on a TPU), which stays the reference the
port is held against. The port imports neither JAX nor ``pnp_ovss_tpu``:
it keeps its own copies of the host-side modules it needs.

Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` at first use and bound with ctypes
(``ops/_build.py``). Each kernel's wrapper runs the kernel on a CUDA tensor
and a plain PyTorch version of the same function on a CPU tensor.
"""

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present (the port's entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def to_device(x, device) -> torch.Tensor:
    """A host array on ``device``, queued on the current stream without
    waiting for the card: a pageable copy to a card synchronises the
    stream, so the copy goes through pinned memory (PyTorch's caching host
    allocator keeps the pinned buffer until the copy has run). On the CPU,
    the array's own memory."""
    t = torch.as_tensor(np.asarray(x))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
