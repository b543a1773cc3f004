"""Transformer half-block kernels: K3 ``mlp_block`` (``csrc/mlp_block.cu``)
and K4 ``attn_block`` (counterparts of ``vit_tpu/ops/pallas/block.py``).

``mlp_block`` is one kernel, as on the TPU: the (M, mlp) hidden never
reaches device memory.

``attn_block`` is four launches, because the TPU kernel's per-image
(S, 3D) QKV does not fit one SM's shared memory (208 x 2304 x 2 B is about
0.96 MB): K1 layernorm, K2 ``LN(x) @ Wqkv + bqkv`` into a packed
``(B*S, 3D)`` buffer, the attention-core kernel (``csrc/attention.cu``)
reading each head's q, k and v straight from that buffer, and K2
``ctx @ Wout + bout + x`` with the residual added in fp32. Every rounding
point of ``_attn_core`` (``block.py:647-699``) is kept.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.cuda.layernorm import layernorm
from vit_tpu_torch.ops.cuda.matmul import matmul

#: Shared memory one block may use on Hopper (227 KB).
MAX_SMEM = 232448
#: Query rows per attention-core block (``csrc/attention.cu``).
ATTN_QT = 64
#: Largest hidden width the bf16 ``mlp_block`` kernel keeps in registers
#: (``csrc/mlp_block.cu``: D/128 accumulator column tiles per warp).
MLP_BF16_MAX_D = 1024
#: Largest hidden width of the fp32 ``mlp_block`` kernel.
MLP_F32_MAX_D = 1536


def mlp_block(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
              eps: float = 1e-12) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` on CUDA tensors in one kernel.
    ``x`` (..., D); ``w1`` (D, mlp); ``w2`` (mlp, D)."""
    _build.check_tensor(x, "x", x)
    d = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != d:
        raise ValueError(f"w1 shape {tuple(w1.shape)} does not take D={d}")
    mlp = w1.shape[1]
    for t, name, shape in ((ln_scale, "ln_scale", (d,)),
                           (ln_bias, "ln_bias", (d,)), (w1, "w1", (d, mlp)),
                           (b1, "b1", (mlp,)), (w2, "w2", (mlp, d)),
                           (b2, "b2", (d,))):
        _build.check_tensor(t, name, x, shape)
    if x.dtype == torch.bfloat16:
        if d % 128 or mlp % 128 or d > MLP_BF16_MAX_D:
            raise ValueError(f"bf16 mlp_block needs D and mlp multiples of "
                             f"128 and D <= {MLP_BF16_MAX_D}; got D={d}, "
                             f"mlp={mlp}")
        for t, name in ((w1, "w1"), (w2, "w2")):
            if t.data_ptr() % 32:
                raise ValueError(f"{name} must be 32-byte aligned for the "
                                 "tensor-core loads")
    elif d > MLP_F32_MAX_D:
        raise ValueError(f"fp32 mlp_block needs D <= {MLP_F32_MAX_D}, got {d}")
    m = x.numel() // d
    if m == 0:
        raise ValueError(f"mlp_block of an empty tensor {tuple(x.shape)}")
    out = torch.empty_like(x)
    _build.launch("vit_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2, out,
                  m, d, mlp, float(eps), like=x)
    count_launch("mlp_block")
    return out


def attention_smem_bytes(seq: int, head_dim: int, itemsize: int) -> int:
    """Dynamic shared memory of one attention-core block: K (rows padded by
    one 4-byte word), V and the query tile in the input dtype, then the
    fp32 scores and row sums (``csrc/attention.cu:attention_smem``)."""
    pad = 4 // itemsize
    elems = seq * (head_dim + pad) + seq * head_dim + ATTN_QT * head_dim
    t = -(-elems * itemsize // 16) * 16
    return t + (ATTN_QT * seq + ATTN_QT) * 4


def attention_core(qkv: torch.Tensor, *, batch: int, num_heads: int,
                   scale: float, seq_len: int) -> torch.Tensor:
    """Masked softmax attention over the packed ``(B*S, 3D)`` ``[q|k|v]``
    buffer (head h at columns ``h*d``), written to a ``(B*S, D)`` buffer at
    each head's columns."""
    _build.check_tensor(qkv, "qkv", qkv)
    if qkv.dim() != 2 or qkv.shape[1] % 3 or qkv.shape[0] % batch:
        raise ValueError(f"qkv shape {tuple(qkv.shape)} is not (B*S, 3D) "
                         f"for B={batch}")
    rows, d = qkv.shape[0], qkv.shape[1] // 3
    s = rows // batch
    if d % num_heads:
        raise ValueError(f"D={d} not divisible by {num_heads} heads")
    if not 0 < seq_len <= s:
        raise ValueError(f"seq_len {seq_len} outside (0, {s}]")
    smem = attention_smem_bytes(s, d // num_heads, qkv.element_size())
    if smem > MAX_SMEM:
        raise ValueError(f"attention core needs {smem} B of shared memory "
                         f"at S={s}, more than {MAX_SMEM}")
    out = torch.empty((rows, d), dtype=qkv.dtype, device=qkv.device)
    _build.launch("vit_attention", qkv, out, batch, s, d, num_heads, seq_len,
                  float(scale), like=qkv)
    count_launch("attention")
    return out


def attn_block(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *,
               num_heads: int, scale: float | None = None,
               seq_len: int | None = None, eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHA(LN(x)))`` for a CUDA tensor ``x`` (B, S, D) with S
    already padded (keys at index >= ``seq_len`` are masked; query rows
    past it are computed and left for the caller to slice off)."""
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
