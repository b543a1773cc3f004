"""Public op library for the slice (counterpart of ``vit_tpu/ops/__init__.py``).

Every op takes ``impl="torch" | "cuda" | None`` (see
:mod:`vit_tpu_torch.ops.dispatch`): ``None`` runs the hand-written kernel
for a CUDA tensor and the plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import resolve_impl
from vit_tpu_torch.ops.reference import patchify

__all__ = [
    "layernorm", "matmul", "patchify", "patch_embed", "attn_block",
    "mlp_block", "resolve_impl", "reference",
]


def layernorm(x, scale, bias, *, eps=1e-12, impl=None):
    """Row layernorm over the last dim (kernel K1)."""
    if resolve_impl(impl, x) == "torch":
        return reference.layernorm(x, scale, bias, eps=eps)
    from vit_tpu_torch.ops.cuda import layernorm as _k
    return _k.layernorm(x, scale, bias, eps=eps)


def matmul(x, w, bias=None, activation=None, *, residual=None, impl=None):
    """``(..., K) @ (K, N)`` + bias, GELU, + residual (kernel K2)."""
    if resolve_impl(impl, x) == "torch":
        return reference.matmul(x, w, bias, activation, residual)
    from vit_tpu_torch.ops.cuda import matmul as _k
    return _k.matmul(x, w, bias, activation, residual)


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
