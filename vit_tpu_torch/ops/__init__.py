"""Public op library for the slice (counterpart of ``vit_tpu/ops/__init__.py``).

Every op takes ``impl="torch" | "cuda" | None`` (see
:mod:`vit_tpu_torch.ops.dispatch`): ``None`` runs the hand-written kernel
for a CUDA tensor and the plain PyTorch version for a CPU tensor.

:func:`attn_plan` and :func:`mlp_plan` say whether a half-block
mega-kernel takes a geometry; the model routes each half of a layer by
them (``vit_tpu_torch/models/vit.py:encoder_block``). They read geometry
and dtype only, never the device, so the plain versions on the CPU walk
the same op sequence as the kernels on the card.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import resolve_impl
from vit_tpu_torch.ops.reference import patchify

__all__ = [
    "layernorm", "layernorm_stats", "matmul", "fused_linear", "patchify",
    "patch_embed", "flash_attention", "attn_block", "mlp_block", "attn_plan",
    "mlp_plan", "resolve_impl", "reference",
]


def layernorm(x, scale, bias, *, eps=1e-12, impl=None):
    """Row layernorm over the last dim (kernel K1)."""
    if resolve_impl(impl, x) == "torch":
        return reference.layernorm(x, scale, bias, eps=eps)
    from vit_tpu_torch.ops.cuda import layernorm as _k
    return _k.layernorm(x, scale, bias, eps=eps)


def layernorm_stats(x, *, eps=1e-12, impl=None):
    """Row mean and ``rsqrt(var + eps)`` as two ``(M, 1)`` fp32 tensors
    (kernel K5)."""
    if resolve_impl(impl, x) == "torch":
        return reference.layernorm_stats(x, eps=eps)
    from vit_tpu_torch.ops.cuda import layernorm as _k
    return _k.layernorm_stats(x, eps=eps)


def matmul(x, w, bias=None, activation=None, *, residual=None, impl=None):
    """``(..., K) @ (K, N)`` + bias, GELU, + residual (kernel K2)."""
    if resolve_impl(impl, x) == "torch":
        return reference.matmul(x, w, bias, activation, residual)
    from vit_tpu_torch.ops.cuda import matmul as _k
    return _k.matmul(x, w, bias, activation, residual)


def fused_linear(x, w, bias=None, activation=None, *, ln_scale=None,
                 ln_bias=None, eps=1e-12, residual=None, impl=None):
    """``act(LN(x) @ w + bias) + residual`` (K5 then K6 with LN; K2
    without)."""
    if resolve_impl(impl, x) == "torch":
        return reference.fused_linear(x, w, bias, activation,
                                      ln_scale=ln_scale, ln_bias=ln_bias,
                                      eps=eps, residual=residual)
    from vit_tpu_torch.ops.cuda import matmul as _k
    return _k.fused_linear(x, w, bias, activation, ln_scale=ln_scale,
                           ln_bias=ln_bias, eps=eps, residual=residual)


def flash_attention(q, k, v, *, scale=None, seq_len=None, impl=None):
    """Softmax attention in (B, H, S, d) layout, keys at index >= ``seq_len``
    masked (kernel K7). ``q``, ``k`` and ``v`` may be strided views."""
    if resolve_impl(impl, q) == "torch":
        return reference.flash_attention(q, k, v, scale=scale,
                                         seq_len=seq_len)
    from vit_tpu_torch.ops.cuda import attention as _k
    return _k.flash_attention(q, k, v, scale=scale, seq_len=seq_len)


def patch_embed(x, w, bias, patch_size, *, impl=None):
    """Patch-embedding convolution as unfold + matmul, as on the JAX Pallas
    tier (``vit_tpu/ops/pallas/patch_embed.py:30-44``): the unfold is a
    layout copy, the projection runs on K2."""
    return matmul(patchify(x, patch_size), w, bias, impl=impl)


def mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps=1e-12, impl=None):
    """``x + fc2(gelu(fc1(LN(x))))``, one kernel (K3)."""
    if resolve_impl(impl, x) == "torch":
        return reference.mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                   eps=eps)
    from vit_tpu_torch.ops.cuda import block as _k
    return _k.mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)


def attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *, num_heads,
               scale=None, seq_len=None, eps=1e-12, impl=None):
    """``x + proj(MHA(LN(x)))`` for ``x`` (B, S, D) (K4: K1, K2, the
    attention core, K2)."""
    if resolve_impl(impl, x) == "torch":
        return reference.attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wout,
                                    bout, num_heads=num_heads, scale=scale,
                                    seq_len=seq_len, eps=eps)
    from vit_tpu_torch.ops.cuda import block as _k
    return _k.attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                         num_heads=num_heads, scale=scale, seq_len=seq_len,
                         eps=eps)


def attn_plan(batch: int, seq_pad: int, hidden: int, num_heads: int,
              dtype: torch.dtype) -> bool:
    """Whether ``attn_block`` takes this geometry: its attention core keeps
    a head's whole K, V and score rows in one block's shared memory. The
    batch does not matter to the port's kernels (counterpart of
    ``vit_tpu.ops.attn_plan``)."""
    from vit_tpu_torch.ops.cuda.block import MAX_SMEM, attention_smem_bytes
    return attention_smem_bytes(seq_pad, hidden // num_heads,
                                dtype.itemsize) <= MAX_SMEM


def mlp_plan(hidden: int, mlp: int, dtype: torch.dtype) -> bool:
    """Whether ``mlp_block`` takes this geometry: in bf16, D and mlp
    multiples of 128 and D <= 1024; in fp32, D <= 1536 (counterpart of
    ``vit_tpu.ops.mlp_plan``)."""
    from vit_tpu_torch.ops.cuda.block import MLP_BF16_MAX_D, MLP_F32_MAX_D
    if dtype == torch.bfloat16:
        return (hidden % 128 == 0 and mlp % 128 == 0
                and hidden <= MLP_BF16_MAX_D)
    return hidden <= MLP_F32_MAX_D
