"""Plain PyTorch versions of every op on the slice (counterpart of
``vit_tpu/ops/reference.py``).

These are the port's oracle: each hand-written CUDA kernel under
``vit_tpu_torch/csrc/`` computes the same function, and the wrappers in
:mod:`vit_tpu_torch.ops` run these versions for tensors that lie on the
CPU. ``impl="torch"`` selects them on any device.

Rounding points follow the Pallas kernels of the JAX package, not its XLA
tier, so that a kernel and its plain version agree to the sum order:

- every product accumulates in fp32 and rounds once, to the input dtype;
- ``attention`` multiplies the unnormalised probabilities, rounded to the
  input dtype, by ``v`` and divides by the fp32 row sum afterwards
  (``vit_tpu/ops/pallas/block.py:685-691``);
- ``mlp_block`` seeds its fp32 accumulator with ``x + b2``
  (``block.py:77-78``) and rounds the GELU hidden to the input dtype
  before the second product (``block.py:86``).
"""

from __future__ import annotations

import torch


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-form GELU: 0.5 * x * (1 + erf(x / sqrt(2)))."""
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-12) -> torch.Tensor:
    """Row layernorm over the last dim: fp32 stats, biased variance, eps
    inside the sqrt; output in the input dtype."""
    x32 = _f32(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * _f32(scale) + _f32(bias)).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           activation: str | None = None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``(..., K) @ (K, N)`` in fp32, then ``+ bias``, then GELU, then
    ``+ residual`` (all fp32), rounded once to ``x.dtype``. ``w`` is
    ``(in, out)``, the transpose of ``nn.Linear``'s layout."""
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    out = torch.matmul(_f32(x), _f32(w))
    if bias is not None:
        out = out + _f32(bias)
    if activation == "gelu":
        out = gelu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    if residual is not None:
        out = out + _f32(residual)
    return out.to(x.dtype)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``(B, C, H, W) -> (B, (H/P)*(W/P), C*P*P)`` with per-patch element
    order (channel, patch_row, patch_col), the order of ``nn.Unfold``."""
    b, c, h, w = x.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"image {tuple(x.shape)} not divisible by patch {p}")
    hp, wp = h // p, w // p
    x = x.reshape(b, c, hp, p, wp, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, hp * wp, c * p * p)


def patch_embed(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
                patch_size: int) -> torch.Tensor:
    """Patch-embedding convolution as unfold + matmul. ``w`` is
    ``(C*P*P, D)``, the conv filter flattened in (c, kh, kw) order and
    transposed."""
    return matmul(patchify(x, patch_size), w, bias)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float | None = None,
              seq_len: int | None = None) -> torch.Tensor:
    """Softmax attention in (B, H, S, d) layout with the Pallas kernel's
    rounding: fp32 scores, keys at index >= ``seq_len`` set to -inf,
    ``p = exp(s - max)``, ``ctx = (p in dtype) @ v / rowsum(p)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(_f32(q), _f32(k).transpose(-1, -2)) * scale
    if seq_len is not None and seq_len != k.shape[-2]:
        keep = torch.arange(k.shape[-2], device=k.device) < seq_len
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(_f32(p.to(q.dtype)), _f32(v)) / l
    return ctx.to(q.dtype)


def attention_core(qkv: torch.Tensor, *, batch: int, num_heads: int,
                   scale: float, seq_len: int) -> torch.Tensor:
    """:func:`attention` on the packed ``(B*S, 3D)`` ``[q|k|v]`` buffer that
    the QKV projection writes (head h at columns ``h*d``); returns the
    ``(B*S, D)`` context with the heads concatenated. The plain version of
    the attention-core kernel (``csrc/attention.cu``)."""
    rows, three_d = qkv.shape
    d = three_d // 3
    s, hd = rows // batch, d // num_heads
    q, k, v = qkv.reshape(batch, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    ctx = attention(q, k, v, scale=scale, seq_len=seq_len)
    return ctx.permute(0, 2, 1, 3).reshape(rows, d)


def attn_block(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *,
               num_heads: int, scale: float | None = None,
               seq_len: int | None = None, eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHA(LN(x)))`` for ``x`` (B, S, D) with every rounding point
    of ``vit_tpu/ops/pallas/block.py:_attn_core``: LN, q/k/v and the
    concatenated context are rounded to the input dtype; the output
    projection adds ``bout`` and the residual in fp32 before one cast."""
    b, s, d = x.shape
    if scale is None:
        scale = (d // num_heads) ** -0.5
    if seq_len is None:
        seq_len = s
    xf = x.reshape(b * s, d)
    qkv = matmul(layernorm(xf, ln_scale, ln_bias, eps=eps), wqkv, bqkv)
    ctx = attention_core(qkv, batch=b, num_heads=num_heads, scale=scale,
                         seq_len=seq_len)
    return matmul(ctx, wout, bout, residual=xf).reshape(b, s, d)


def mlp_block(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
              eps: float = 1e-12) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` with the Pallas kernel's rounding: LN
    and the GELU hidden in the input dtype, the fp32 accumulator seeded
    with ``x + b2``."""
    h = matmul(layernorm(x, ln_scale, ln_bias, eps=eps), w1, b1, "gelu")
    acc = _f32(x) + _f32(b2)
    return (acc + torch.matmul(_f32(h), _f32(w2))).to(x.dtype)
