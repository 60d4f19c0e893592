"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ctypes. All sources are compiled
at the first use of any kernel, one ``nvcc`` process per source, all
started together. Libraries are cached under ``build/cuda/`` at the
repository root, keyed by a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.

``LAUNCHES`` counts kernel launches by kernel name. A wrapper adds one
where it launches its kernel and nowhere else; the plain PyTorch version
a wrapper runs for CPU tensors is not counted. With the tracer on, the
nvcc runs are one ``build.compile`` span, each library's load a
``build.load`` span, and ``build.compiled`` counts the sources built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from pnp_ovss_tpu_torch.utils.tracing import TRACER

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cuda"

# Source name -> (C entry point, its ctypes argument types).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES: Dict[str, Dict[str, list]] = {
    "flash_attention": {
        "flash_mha_flat_bf16": [_P] * 4 + [_L] * 8 + [_I] * 5 + [_F, _P],
        "flash_mha_xlen_bf16": [_P] * 4 + [_L] * 8 + [_I] * 6 + [_F, _P],
        "flash_mha_bhsd_bf16": [_P] * 4 + [_L] * 12 + [_I] * 4 + [_F, _P],
        "flash_mha_stall": [_P],
    },
    "crf_materialize": {
        "gaussian_kernel_materialize": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "crf_iteration": {
        "crf_fused_iteration": [_P, _P, _P, _P, _P, _P] + [_I] * 5 + [_P],
    },
    "crf_spatial": {
        "crf_spatial_operands": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        "crf_first_state": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    },
    "crf_matmul": {
        "gaussian_kernel_matmul": [_P] * 6 + [_I] * 7 + [_L, _I, _P],
        "gaussian_kernel_matmul_symmetric": [_P] * 5 + [_I] * 6
        + [_L, _I, _P],
        "gaussian_kernel_matmul_stall": [_P],
    },
    "ln_matmul": {
        "ln_matmul_bf16": [_P] * 7 + [_I] * 3 + [_F, _P],
    },
    "ln_mlp_residual": {
        "ln_mlp_residual_bf16": [_P] * 10 + [_I] * 3 + [_F, _P],
    },
    "flash_qkv_proj": {
        "flash_mha_qkv_proj_bf16": [_P] * 6 + [_I] * 6 + [_F, _P],
        "qkv_proj_residual_bf16": [_P] * 5 + [_I] * 3 + [_P],
    },
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {
    "ln_matmul": 0,
    "flash_mha_flat_qkv": 0,
    "flash_mha_flat": 0,
    "ln_mlp_residual": 0,
    "flash_mha_qkv_proj": 0,
    "flash_mha_flat_xlen": 0,
    "flash_mha": 0,
    "gaussian_kernel_materialize": 0,
    "crf_fused_iteration": 0,
    "crf_spatial_operands": 0,
    "crf_first_state": 0,
    "gaussian_kernel_matmul": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.
    Returns source name -> library path; raises with nvcc's output on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    stale = [name for name, path in paths.items() if not path.exists()]
    if not stale:
        return paths
    failed = []
    with TRACER.span("build.compile", source=",".join(stale)):
        procs = {}
        for name in stale:
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (rc {proc.returncode})\n{out}")
            else:
                os.replace(tmp, paths[name])
                TRACER.count("build.compiled")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        paths = build_all()
        for src, path in paths.items():
            with TRACER.span("build.load", source=src):
                dll = ctypes.CDLL(str(path))
            for fn, argtypes in SOURCES[src].items():
                getattr(dll, fn).argtypes = argtypes
                getattr(dll, fn).restype = ctypes.c_int
            dll.pnp_error_string.argtypes = [ctypes.c_int]
            dll.pnp_error_string.restype = ctypes.c_char_p
            _libs[src] = dll
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.pnp_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, **tensors: torch.Tensor) -> None:
    """Check that every tensor is a contiguous CUDA tensor on one device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def require_bf16(name: str, **tensors: torch.Tensor) -> None:
    """Check that every tensor is bfloat16 (what the kernels read)."""
    for k, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {k} must be bfloat16, got {t.dtype}")
