"""Fused LayerNorm + matmul kernels of the ViT block (kernels K1 and K3).

Counterpart of ``pnp_ovss_tpu/ops/vit_block_pallas.py``:

- ``ln_matmul``        y = LN(x) @ W^T + b            (K1: norm1 + qkv)
- ``ln_mlp_residual``  y = x + gelu(LN(x) @ W1^T + b1) @ W2^T + b2
                                                     (K3: norm2 + MLP)

Weights are in ``nn.Linear`` layout ([out, in]), as the port's modules
hold them. On a CUDA tensor the wrappers launch the CUDA kernels
(``csrc/ln_matmul.cu``, ``csrc/ln_mlp_residual.cu``: a row LayerNorm and
the wgmma GEMM of ``csrc/wgmma_gemm.cuh``; bf16 in and out) or raise; on
a CPU tensor they run the plain versions, which follow the Pallas bodies'
value flow step by step:

- K1: f32 two-pass LayerNorm -> compute dtype -> product with f32
  accumulation -> ``+ bias`` in f32 -> one rounding;
- K3: the same LayerNorm -> fc1 with f32 accumulation ``+ b1`` -> round
  -> exact-erf gelu in the compute dtype (bf16: the clamped minimax erf,
  in f32) -> fc2 with f32 accumulation ``+ b2`` -> round -> ``x + out``.

The erf is the JAX package's own polynomial (``_ERF_P``), copied here so
that both packages round the same values: a bf16 gelu through ``erff``
would differ on some codes.
"""

from __future__ import annotations

import math

import torch

from pnp_ovss_tpu_torch.ops import _build


def supported(d_model: int, d_out: int | None = None,
              mlp_hidden: int | None = None) -> bool:
    """Shapes the fused kernels take (the JAX package's rule, so both
    packages route a configuration the same way)."""
    ok = d_model % 128 == 0
    if d_out is not None:
        ok = ok and d_out % 128 == 0
    if mlp_hidden is not None:
        ok = ok and mlp_hidden % 128 == 0
    return ok


# erf(x) = x * P(x^2) on |x| <= 2.2, |x| clamped to 2.2 (exact after a
# bf16 round: erf(x >= 2.19) rounds to 1.0 there).
_ERF_P = (1.128379139571155, -0.3761252259731045, 0.11282976424513898,
          -0.026843839553998192, 0.0051925774717181995,
          -0.0008290527520228961, 0.00010732167832988502,
          -1.0523825720237124e-05, 6.793275336392753e-07,
          -2.1076366182700845e-08)


def _horner(coeffs, t: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _erf_f32(x: torch.Tensor) -> torch.Tensor:
    """Clamped single-branch erf (f32 in and out)."""
    xc = x.clamp(-2.2, 2.2)
    return xc * _horner(_ERF_P, xc * xc)


def _erf_f32_full(x: torch.Tensor) -> torch.Tensor:
    """f32-accurate erf: the polynomial core plus an erfc tail
    (Abramowitz-Stegun 7.1.26) for |x| > 2.2."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    tail = 1.0 - poly * torch.exp(-ax * ax)
    return torch.where(ax <= 2.2, _erf_f32(x), torch.sign(x) * tail)


def gelu_exact(y: torch.Tensor) -> torch.Tensor:
    """y * (erf(y / sqrt2) + 1) / 2 with the JAX kernels' steps and dtype
    flow: every step is computed in f32 and rounded to ``y``'s dtype, the
    erf itself in f32 (clamped polynomial for bf16, with the erfc tail
    otherwise)."""
    dt = y.dtype
    yf = y.float()
    # A tensor divisor: CUDA turns division by a scalar into a product
    # with its reciprocal, which rounds differently.
    sqrt2 = torch.full_like(yf, torch.tensor(math.sqrt(2), dtype=dt).item())
    t = (yf / sqrt2).to(dt)
    erf = _erf_f32 if dt == torch.bfloat16 else _erf_f32_full
    e = erf(t.float()).to(dt)
    half = ((e.float() + 1.0).to(dt).float() / 2.0).to(dt)
    return (yf * half.float()).to(dt)


def layer_norm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Two-pass LayerNorm in f32 (the Pallas bodies' ``_layer_norm_f32``)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * gamma.float() \
        + beta.float()


def ln_matmul_plain(x, gamma, beta, w, bias, *, eps: float) -> torch.Tensor:
    """Plain version of K1: x [M, D], w [N, D] -> [M, N] in w's dtype."""
    dt = w.dtype
    h = layer_norm_f32(x, gamma, beta, eps).to(dt)
    return (h.float() @ w.float().T + bias.float()).to(dt)


def ln_mlp_residual_plain(x, gamma, beta, w1, b1, w2, b2, *,
                          eps: float) -> torch.Tensor:
    """Plain version of K3: x [M, D], w1 [F, D], w2 [D, F] -> [M, D] in
    x's dtype."""
    dt = x.dtype
    h = layer_norm_f32(x, gamma, beta, eps).to(dt)
    y = (h.float() @ w1.float().T + b1.float()).to(dt)
    g = gelu_exact(y)
    out = (g.float() @ w2.float().T + b2.float()).to(dt)
    return (x.float() + out.float()).to(dt)


def _check_norm(name: str, d: int, gamma, beta) -> None:
    """gamma/beta as the row LayerNorm reads them, and a width it takes:
    D % 64 == 0 up to 1024 (every width ``supported`` routes here)."""
    for k, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or t.shape != (d,):
            raise ValueError(f"{name}: {k} must be float32 of shape ({d},)")
    if d % 64 or not 0 < d <= 1024:
        raise ValueError(f"{name}: needs D % 64 == 0 and D <= 1024, got "
                         f"D={d}")


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-6) -> torch.Tensor:
    """LN(x) @ w^T + bias. x [M, D]; gamma/beta [D] f32; w [N, D];
    bias [N]. Returns [M, N] in w's dtype. On the card one call runs two
    kernels (row LayerNorm, then the wgmma GEMM with the bias epilogue) on
    the normalised rows [M, D], scratch this wrapper allocates."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, gamma, beta, w, bias, eps=eps)
    m, d = x.shape
    n = w.shape[0]
    _build.require_cuda("ln_matmul", x=x, gamma=gamma, beta=beta, w=w,
                        bias=bias)
    _build.require_bf16("ln_matmul", x=x, w=w, bias=bias)
    _check_norm("ln_matmul", d, gamma, beta)
    if w.shape != (n, d) or bias.shape != (n,):
        raise ValueError(f"ln_matmul: w {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not match D={d}")
    if n % 128:
        raise ValueError(f"ln_matmul: needs N % 128 == 0, got N={n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    xn = torch.empty_like(x)
    lib = _build.library("ln_matmul")
    rc = lib.ln_matmul_bf16(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        bias.data_ptr(), xn.data_ptr(), out.data_ptr(), m, d, n, eps,
        _build.stream_ptr(x))
    _build.check(lib, rc, "ln_matmul")
    _build.LAUNCHES["ln_matmul"] += 1
    return out


def ln_mlp_residual(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x + gelu(LN(x) @ w1^T + b1) @ w2^T + b2. x [M, D]; w1 [F, D];
    w2 [D, F]. Returns [M, D] in x's dtype. On the card one call runs
    three kernels (row LayerNorm, fc1 + gelu, fc2 + residual; wgmma fed by
    TMA) on scratch this wrapper allocates: the normalised rows [M, D] and
    the bf16 gelu hidden [M, F], which makes one round trip through device
    memory."""
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, gamma, beta, w1, b1, w2, b2, eps=eps)
    m, d = x.shape
    f = w1.shape[0]
    _build.require_cuda("ln_mlp_residual", x=x, gamma=gamma, beta=beta,
                        w1=w1, b1=b1, w2=w2, b2=b2)
    _build.require_bf16("ln_mlp_residual", x=x, w1=w1, b1=b1, w2=w2,
                         b2=b2)
    _check_norm("ln_mlp_residual", d, gamma, beta)
    if (w1.shape != (f, d) or b1.shape != (f,) or w2.shape != (d, f)
            or b2.shape != (d,)):
        raise ValueError("ln_mlp_residual: weight shapes do not match "
                         f"D={d}, F={f}")
    if f % 32:
        raise ValueError(f"ln_mlp_residual: needs F % 32 == 0, got F={f}")
    out = torch.empty_like(x)
    if m == 0:
        return out
    xn = torch.empty_like(x)
    hidden = torch.empty((m, f), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("ln_mlp_residual")
    rc = lib.ln_mlp_residual_bf16(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), xn.data_ptr(),
        hidden.data_ptr(), out.data_ptr(), m, d, f, eps, _build.stream_ptr(x))
    _build.check(lib, rc, "ln_mlp_residual")
    _build.LAUNCHES["ln_mlp_residual"] += 1
    return out
