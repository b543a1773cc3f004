"""The int8 tier's kernels: K10 ``quantize_rows`` (``csrc/layernorm.cu``,
in the form :func:`quantize_rows_form` names),
K11 ``matmul_i8`` (``csrc/matmul_i8_wgmma.cu``, or ``csrc/matmul.cu`` where
:func:`i8_path` says), K12 ``mlp_block_i8dot`` (``csrc/mlp_block_i8.cu`` on
``csrc/mlp_i8_wgmma.cuh``), K17 ``mlp_block_q`` (``csrc/mlp_block_q.cu``)
and ``attn_block_q`` as five launches (counterparts of
``vit_tpu/ops/pallas/block.py:attn_block_q``, ``mlp_block_i8dot`` and
``mlp_block_q``); and their tensor-parallel shard forms: K12 and K17 with
``partial_out=True``, and B17 ``attn_block_q_partial``
(``block.py:1443``, ``pallas_call`` :1483), ``attn_block_q``'s five
launches on one shard's heads with no bias and no residual in the last
K11: each shard quantizes its context rows over its own ``dl`` columns, as
JAX's partial kernel does. Neither attention half counts launches of its
own: each of its kernels counts its launch.

``attn_block_q`` is one Pallas kernel on the TPU; on Hopper it is K10 with
LN1, K11 into the packed ``(B*S, 3D)`` q|k|v in the dtype, K7 on the heads'
strided views with an fp32 ``(B, S, H, d)`` output (a ``(B*S, D)`` view),
K10 over each whole context row, and K11 with ``+ bout + x``. K7 and not
the attention core, because the core keeps a head's whole K and V in one
block's shared memory and cannot take L/16-384's 592 tokens; K7 streams
them. Its softmax is taken relative to a running max, where the Pallas
kernel takes the row max: in bf16 that moves where ``p`` is rounded, by at
most one ulp of ``p``.

Weights are int8 with fp32 per-output-channel scales; activations,
biases, LN params and outputs are in the model's dtype.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import mlp_q_plan
from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.cuda.attention import flash_attention
from vit_tpu_torch.ops.reference import MLP_GROUP

#: Largest model width K12 takes (H/14).
MLP_I8_MAX_D = 1280

_I8, _F32 = torch.int8, torch.float32


#: The C interface's code of each :func:`quantize_rows_form` result.
QUANTIZE_ROWS_FORMS = {"scalar": 0, "row": 1}
#: The widest row K10's row form holds in registers (H/14).
QUANTIZE_ROWS_MAX_D = 1280


def quantize_rows_form(d: int) -> str:
    """The form K10 quantizes rows of ``d`` values in
    (``csrc/layernorm.cu``): ``"row"`` (each row read once into registers,
    the codes stored four bytes a lane) where
    ``d`` is a multiple of 128 up to :data:`QUANTIZE_ROWS_MAX_D` -- B/16's
    768, L/16's 1024, H/14's 1280, the model=2 shard's 384 -- else
    ``"scalar"`` (one warp a row, ``common.cuh:quantize_row``). The two
    give the same bits: the row form keeps the scalar one's element
    ownership and sum order. ``d`` alone decides, before the launch."""
    if d <= 0:
        raise ValueError(f"quantize_rows of rows of {d} values")
    return "row" if d % 128 == 0 and d <= QUANTIZE_ROWS_MAX_D else "scalar"


def quantize_rows(x: torch.Tensor, *, ln_scale: torch.Tensor | None = None,
                  ln_bias: torch.Tensor | None = None,
                  eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of a CUDA tensor ``x`` (..., D), optionally after an
    fp32 LN: ``(xq (M, D) int8, ax (M, 1) fp32)``, in the form
    :func:`quantize_rows_form` names."""
    _build.check_tensor(x, "x", x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        raise ValueError(f"quantize_rows of an empty tensor {tuple(x.shape)}")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    if ln_scale is not None:
        _build.check_tensor(ln_scale, "ln_scale", x, (d,))
        _build.check_tensor(ln_bias, "ln_bias", x, (d,))
    xq = torch.empty((rows, d), dtype=_I8, device=x.device)
    ax = torch.empty((rows, 1), dtype=_F32, device=x.device)
    _build.launch("vit_quantize_rows", x, ln_scale, ln_bias, xq, ax, rows, d,
                  float(eps), QUANTIZE_ROWS_FORMS[quantize_rows_form(d)],
                  like=x)
    count_launch("quantize_rows")
    return xq, ax


#: The C entry point of each :func:`i8_path` result.
I8_ENTRIES = {"wgmma": "vit_matmul_i8_wgmma", "wmma": "vit_matmul_i8"}


def i8_path(m: int, n: int, k: int, ptrs: tuple[int, int]) -> str:
    """The tile K11 runs ``(m, k) @ (k, n)`` on, from shape and alignment
    alone: ``"wgmma"`` (the s8 ``wgmma`` tile fed by TMA) where TMA can
    read both operands -- xq's and wq's bases (``ptrs``, bytes) 16-byte
    aligned, K and N multiples of 16 -- else ``"wmma"``
    (``gemm_tile.cuh``'s int8 tile)."""
    if min(m, n, k) <= 0:
        raise ValueError(f"matmul_i8 of an empty operand ({m}, {k}) @ "
                         f"({k}, {n})")
    if all(p % 16 == 0 for p in ptrs) and k % 16 == 0 and n % 16 == 0:
        return "wgmma"
    return "wmma"


def matmul_i8(xq: torch.Tensor, ax: torch.Tensor, wq: torch.Tensor,
              wscale: torch.Tensor, bias: torch.Tensor | None = None,
              activation: str | None = None, *,
              residual: torch.Tensor | None = None,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``xq (M, K) int8 @ wq (K, N) int8`` on CUDA tensors, exact int32
    sums, then ``(acc * ax) * wscale``, ``+ bias``, GELU, ``+ residual`` in
    fp32, one cast to ``out_dtype``; ``bias`` and ``residual`` (M, N) are
    in ``out_dtype``. ``wq`` is read where it lies, on the tile
    :func:`i8_path` picks."""
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    _build.check_tensor(xq, "xq", xq, dtype=_I8)
    if xq.dim() != 2 or wq.dim() != 2 or wq.shape[0] != xq.shape[1]:
        raise ValueError(f"matmul_i8 shapes {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)}")
    (m, k), n = xq.shape, wq.shape[1]
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"matmul_i8 of an empty operand {tuple(xq.shape)} "
                         f"@ {tuple(wq.shape)}")
    _build.check_tensor(ax, "ax", xq, (m, 1), dtype=_F32)
    _build.check_tensor(wq, "wq", xq, (k, n), dtype=_I8)
    _build.check_tensor(wscale, "wscale", xq, (n,), dtype=_F32)
    if bias is not None:
        _build.check_tensor(bias, "bias", xq, (n,), dtype=out_dtype)
    if residual is not None:
        _build.check_tensor(residual, "residual", xq, (m, n), dtype=out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    path = i8_path(m, n, k, (xq.data_ptr(), wq.data_ptr()))
    _build.launch(I8_ENTRIES[path], xq, ax, wq, wscale, bias, residual, out,
                  m, n, k, int(activation == "gelu"), like=out)
    count_launch("matmul_i8")
    return out


def _attn_q_half(x: torch.Tensor, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                 wout_q, sout, bout, *, num_heads: int, scale: float | None,
                 seq_len: int | None, eps: float,
                 residual: bool) -> torch.Tensor:
    """The five launches of both int8 attention halves on a CUDA tensor
    ``x`` (B, S, D), S already padded (the module docstring's), dl from
    ``wqkv_q``: the context rows are quantized over their dl columns, and
    the last K11 adds ``bout`` and, with ``residual``, ``x``."""
    _build.check_tensor(x, "x", x)
    if x.dim() != 3:
        raise ValueError(f"x shape {tuple(x.shape)} is not (B, S, D)")
    b, s, d = x.shape
    if wqkv_q.dim() != 2 or wqkv_q.shape[1] % 3:
        raise ValueError(f"wqkv_q shape {tuple(wqkv_q.shape)} is not "
                         "(D, 3*dl)")
    dl = wqkv_q.shape[1] // 3
    if num_heads <= 0 or dl % num_heads:
        raise ValueError(f"dl={dl} not divisible by {num_heads} heads")
    hd = dl // num_heads
    xf = x.reshape(b * s, d)
    xq, ax = quantize_rows(xf, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps)
    qkv = matmul_i8(xq, ax, wqkv_q, sqkv, bqkv, out_dtype=x.dtype)
    q, k, v = qkv.view(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    ctx = flash_attention(q, k, v, scale=hd ** -0.5 if scale is None
                          else scale, seq_len=seq_len, out_dtype=_F32)
    # The kernel's context is a (B, S, H, hd) buffer: this is a view.
    cq, ac = quantize_rows(ctx.transpose(1, 2).reshape(b * s, dl))
    return matmul_i8(cq, ac, wout_q, sout, bout,
                     residual=xf if residual else None,
                     out_dtype=x.dtype).view(b, s, d)


def attn_block_q(x: torch.Tensor, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                 wout_q, sout, bout, *, num_heads: int,
                 scale: float | None = None, seq_len: int | None = None,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHA(LN(x)))`` with int8 projections for a CUDA tensor
    ``x`` (B, S, D), S already padded (keys at index >= ``seq_len`` are
    masked): five launches, the module docstring's."""
    return _attn_q_half(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q,
                        sout, bout, num_heads=num_heads, scale=scale,
                        seq_len=seq_len, eps=eps, residual=True)


def attn_block_q_partial(x: torch.Tensor, ln_scale, ln_bias, wqkv_q, sqkv,
                         bqkv, wout_q, sout, *, num_heads: int,
                         scale: float | None = None,
                         seq_len: int | None = None,
                         eps: float = 1e-12) -> torch.Tensor:
    """``proj_s(MHA_s(LN(x)))`` with int8 projections for a CUDA tensor
    ``x`` (B, S, D), S already padded: one tensor-parallel shard's
    attention half, ``num_heads`` its heads, ``wqkv_q`` (D, 3*dl) int8 its
    head-major ``[q_s|k_s|v_s]`` columns with ``sqkv`` (3*dl,) fp32 and
    ``bqkv`` (3*dl,), ``wout_q`` (dl, D) int8 its rows with the whole
    ``sout`` (D,). No bias and no residual; the result is in ``x.dtype``."""
    return _attn_q_half(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q,
                        sout, None, num_heads=num_heads, scale=scale,
                        seq_len=seq_len, eps=eps, residual=False)


def _int8_mlp(kernel: str, entry: str, x: torch.Tensor, ln_scale, ln_bias,
              w1q, s1, b1, w2q, s2, b2, eps: float,
              partial_out: bool) -> torch.Tensor:
    """Check the operands of an int8-weight MLP kernel (K12 or K17), launch
    C entry point ``entry`` and count a launch of ``kernel`` (of
    ``kernel + "_partial"`` with ``partial_out``)."""
    _build.check_tensor(x, "x", x)
    d = x.shape[-1]
    if w1q.dim() != 2 or w1q.shape[0] != d:
        raise ValueError(f"w1q shape {tuple(w1q.shape)} does not take D={d}")
    mlp = w1q.shape[1]
    if not mlp_q_plan(d, mlp):
        raise ValueError(f"{kernel} needs D a multiple of 128 up to "
                         f"{MLP_I8_MAX_D} and mlp a multiple of the quant "
                         f"group {MLP_GROUP}; got D={d}, mlp={mlp}")
    for t, name, shape, dt in (
            (ln_scale, "ln_scale", (d,), None), (ln_bias, "ln_bias", (d,), None),
            (w1q, "w1q", (d, mlp), _I8), (s1, "s1", (mlp,), _F32),
            (b1, "b1", (mlp,), None), (w2q, "w2q", (mlp, d), _I8),
            (s2, "s2", (d,), _F32), (b2, "b2", (d,), None)):
        _build.check_tensor(t, name, x, shape, dtype=dt)
    for t, name in ((w1q, "w1q"), (w2q, "w2q")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    m = x.numel() // d
    if m == 0:
        raise ValueError(f"{kernel} of an empty tensor {tuple(x.shape)}")
    out = torch.empty_like(x)
    _build.launch(entry, x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, out,
                  m, d, mlp, float(eps), int(partial_out), like=x)
    count_launch(kernel + "_partial" if partial_out else kernel)
    return out


def mlp_block_i8dot(x: torch.Tensor, ln_scale, ln_bias, w1q, s1, b1, w2q, s2,
                    b2, *, eps: float = 1e-12,
                    partial_out: bool = False) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` with both products in int8 on a CUDA
    tensor ``x`` (..., D), one kernel. ``w1q`` (D, mlp) and ``w2q``
    (mlp, D) int8, ``s1`` (mlp,) and ``s2`` (D,) fp32; D a multiple of 128
    up to 1280, mlp a multiple of 512. ``partial_out=True``: the shard
    form, accumulator seeded with zero, ``b2`` not read."""
    return _int8_mlp("mlp_block_i8dot", "vit_mlp_block_i8", x, ln_scale,
                     ln_bias, w1q, s1, b1, w2q, s2, b2, eps, partial_out)


def mlp_block_q(x: torch.Tensor, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2,
                *, eps: float = 1e-12,
                partial_out: bool = False) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` on weight-only int8 weights for a CUDA
    tensor ``x`` (..., D), one kernel (K17, ``csrc/mlp_block_q.cu``): the
    activations stay in ``x``'s dtype, the weights are converted to it as
    they are staged. The operands and limits of :func:`mlp_block_i8dot`
    (mlp a multiple of 512: K17's chunk); ``partial_out`` as there."""
    return _int8_mlp("mlp_block_q", "vit_mlp_block_q", x, ln_scale, ln_bias,
                     w1q, s1, b1, w2q, s2, b2, eps, partial_out)
