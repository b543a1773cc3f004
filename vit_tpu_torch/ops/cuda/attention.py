"""Flash-attention kernel K7 (``csrc/flash_attention.cu``), the counterpart
of ``vit_tpu/ops/pallas/attention.py:flash_attention`` in all three of its
regimes. The kernel reads q, k and v through their strides, so the heads of
a packed ``(B*S, 3D)`` QKV buffer go in as views, and writes a
``(B, S, H, d)`` buffer that is returned as a ``(B, H, S, d)`` view: the
model reads it back as ``(B*S, D)`` with no copy. The buffer is in the
inputs' dtype or, for the int8 tier's attention, fp32; both count as
``flash_attention`` launches. Its backward is K13
(:func:`flash_attention_bwd`), the counterpart of
``vit_tpu/ops/pallas/vjp.py:_attention_bwd``."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch

#: Largest head_dim the kernel takes; it must also be a multiple of 16.
MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, seq_len: int | None = None,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``softmax(q kᵀ · scale) v`` over CUDA tensors ``(B, H, S, d)``, keys
    at index >= ``seq_len`` masked, in ``out_dtype`` (``q.dtype`` or
    fp32). Each operand may be any strided view whose last dim is
    contiguous."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_tensor(t, name, q, contiguous=False)
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} is not the "
                             f"(B, H, S, d) shape of q {tuple(q.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    b, h, s, d = q.shape
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if scale is None:
        scale = d ** -0.5
    if seq_len is None:
        seq_len = s
    if not 0 < seq_len <= s:
        raise ValueError(f"seq_len {seq_len} outside (0, {s}]")
    if b * h == 0:
        raise ValueError(f"flash_attention of an empty batch {tuple(q.shape)}")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} must be {q.dtype} or "
                         "torch.float32")
    out = torch.empty((b, s, h, d), dtype=out_dtype, device=q.device)
    out = out.permute(0, 2, 1, 3)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    _build.launch("vit_flash_attention", q, k, v, out, *strides, b, h, s, d,
                  seq_len, float(scale), int(out_dtype == torch.float32),
                  like=q)
    count_launch("flash_attention")
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, *, scale: float | None = None,
                        seq_len: int | None = None) -> torch.Tensor:
    """The gradients of :func:`flash_attention` (K13,
    ``csrc/flash_attention_bwd.cu``) for the output gradient ``g``, all four
    CUDA tensors ``(B, H, S, d)`` in one dtype, each any strided view whose
    last dim is contiguous. Returns the packed ``(B, S, 3, H, d)`` buffer
    ``[dq | dk | dv]`` in that dtype. One call is two launches (query-major
    for dq, key-major for dk and dv, with a ``(3, B*H, S)`` fp32 scratch of
    the rows' softmax stats between them), counted once as
    ``flash_attention_bwd``."""
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (g, "g")):
        _build.check_tensor(t, name, q, contiguous=False)
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} is not the "
                             f"(B, H, S, d) shape of q {tuple(q.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    b, h, s, d = q.shape
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if scale is None:
        scale = d ** -0.5
    if seq_len is None:
        seq_len = s
    if not 0 < seq_len <= s:
        raise ValueError(f"seq_len {seq_len} outside (0, {s}]")
    if b * h == 0:
        raise ValueError(f"flash_attention_bwd of an empty batch "
                         f"{tuple(q.shape)}")
    out = torch.empty((b, s, 3, h, d), dtype=q.dtype, device=q.device)
    grads = out.permute(2, 0, 3, 1, 4).unbind(0)
    stats = torch.empty((3, b * h, s), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v, g, *grads) for st in t.stride()[:3]]
    _build.launch("vit_flash_attention_bwd", q, k, v, g, *grads, *strides,
                  stats, b, h, s, d, seq_len, float(scale), like=q)
    count_launch("flash_attention_bwd")
    return out
