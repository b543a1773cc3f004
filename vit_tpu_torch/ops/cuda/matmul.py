"""Tiled GEMM kernel K2 and its LN-prologue form K6 (``csrc/matmul.cu``),
the counterparts of ``vit_tpu/ops/pallas/matmul.py:matmul`` and
``fused_linear``. K2 has one extension: an optional residual added in fp32
before the single cast, which the split ``attn_block`` needs to keep
``_attn_core``'s rounding."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.cuda.layernorm import layernorm_stats


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
           activation: str | None, residual: torch.Tensor | None):
    """Check the operands of a GEMM; return ``(m, n, k, out_shape)``."""
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    _build.check_tensor(x, "x", x)
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    _build.check_tensor(w, "w", x, (k, n))
    if bias is not None:
        _build.check_tensor(bias, "bias", x, (n,))
    out_shape = (*x.shape[:-1], n)
    if residual is not None:
        _build.check_tensor(residual, "residual", x, out_shape)
    m = x.numel() // k if k else 0
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"matmul of an empty operand {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    return m, n, k, out_shape


def matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           activation: str | None = None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``(..., K) @ (K, N)`` on CUDA tensors, fp32 accumulation, then
    ``+ bias``, GELU and ``+ residual`` in fp32, one cast to ``x.dtype``.
    ``residual`` has the output's shape ``(..., N)``."""
    m, n, k, out_shape = _check(x, w, bias, activation, residual)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch("vit_matmul", x, w, bias, residual, out, m, n, k,
                  int(activation == "gelu"), like=x)
    count_launch("matmul")
    return out


def fused_linear(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 activation: str | None = None, *,
                 ln_scale: torch.Tensor | None = None,
                 ln_bias: torch.Tensor | None = None, eps: float = 1e-12,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(LN(x) @ w + bias) + residual`` on CUDA tensors. With
    ``ln_scale`` and ``ln_bias`` it is two launches, as in JAX: K5 for the
    row stats, then K6 normalising x as it stages it; without them, one
    launch of K2, whose epilogue is the same."""
    m, n, k, out_shape = _check(x, w, bias, activation, residual)
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    gelu = int(activation == "gelu")
    if ln_scale is None:
        _build.launch("vit_matmul", x, w, bias, residual, out, m, n, k, gelu,
                      like=x)
    else:
        _build.check_tensor(ln_scale, "ln_scale", x, (k,))
        _build.check_tensor(ln_bias, "ln_bias", x, (k,))
        mu, rstd = layernorm_stats(x, eps=eps)
        _build.launch("vit_fused_linear", x, w, bias, residual, mu, rstd,
                      ln_scale, ln_bias, out, m, n, k, gelu, like=x)
    count_launch("fused_linear")
    return out
