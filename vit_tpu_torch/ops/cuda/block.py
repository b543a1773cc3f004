"""Transformer block kernels: K3 ``mlp_block`` (``csrc/mlp_block.cu``), K4
``attn_block`` and the full layer ``layer_block`` (K18,
``csrc/layer_block.cu``) (counterparts of ``vit_tpu/ops/pallas/block.py``),
and the half blocks' tensor-parallel shard forms: K3 with
``partial_out=True`` and B16 ``attn_block_partial``.

``mlp_block`` is one kernel, as on the TPU: the (M, mlp) hidden never
reaches device memory.

``attn_block`` is four launches, because the TPU kernel's per-image
(S, 3D) QKV does not fit one SM's shared memory (208 x 2304 x 2 B is about
0.96 MB): K1 layernorm, K2 ``LN(x) @ Wqkv + bqkv`` into a packed
``(B*S, 3D)`` buffer, the attention-core kernel (``csrc/attention.cu``)
reading each head's q, k and v straight from that buffer, and K2
``ctx @ Wout + bout + x`` with the residual added in fp32. Every rounding
point of ``_attn_core`` (``block.py:647-699``) is kept. Where the core's
shared memory refuses the length (``ops.attn_plan``), K7 over the buffer's
head views takes its place, as the model's composed route does.

``attn_block_partial`` (B16, ``block.py:1018`` ``attn_block_partial``,
``pallas_call`` :1054) is the same four launches on one shard's heads: the
buffer is ``(B*S, 3*dl)`` ``[q_s|k_s|v_s]`` and the last K2 ``ctx @
Wout_s`` has no bias and no residual. Its output is a partial sum in
``x.dtype``, which the caller all-reduces over the model group
(``vit_tpu_torch/parallel/tp.py``). Neither block counts launches of its
own: each of its kernels counts its launch.

``layer_block`` (B18, ``block.py:1687-1832``) is ``attn_block``'s first
three launches, then K18 on the context: the out-projection, LN2 and the
MLP with the sum between the halves kept in fp32 on chip, where the pair
``attn_block`` -> ``mlp_block`` rounds it to the dtype in device memory. In
bf16 K18 is K3's ``wgmma`` cluster tile with the out-projection in front
(``csrc/mlp_wgmma.cuh``): y lives in the fc2 accumulators' registers, split
between the cluster's two blocks by columns, and seeds them (``y + b2``);
at D >= 896 the second pass's y waits unrounded in the output's own bytes.
In fp32 y sits in registers and shared memory (``csrc/layer_block.cu``).
K18 counts as ``layer_block``.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.cuda.attention import flash_attention
from vit_tpu_torch.ops.cuda.layernorm import layernorm
from vit_tpu_torch.ops.cuda.matmul import matmul

#: Shared memory one block may use on Hopper (227 KB).
MAX_SMEM = 232448
#: Query rows per attention-core block (``csrc/attention.cu``).
ATTN_QT = 64
#: Largest hidden width of the bf16 ``mlp_block`` kernel
#: (``csrc/mlp_wgmma.cuh``: LN(x) of its 64 rows, 128 KB of shared memory
#: at 1024, beside the h buffers and the weight rings).
MLP_BF16_MAX_D = 1024
#: Largest hidden width of the fp32 ``mlp_block`` kernel.
MLP_F32_MAX_D = 1536
#: The fp32 forms of ``mlp_block`` (the C entry point's ``form``).
MLP_F32_FORMS = {"ffma": 0, "tf32": 1}


def mlp_f32_form(d: int, mlp: int, ptrs: tuple[int, ...]) -> str:
    """The form K3 runs an fp32 MLP of width ``d`` and hidden ``mlp`` in:
    ``"tf32"`` (``csrc/mlp_tf32.cuh``: the tensor cores, three TF32
    passes) where TMA can read x, w1 and w2 -- their bases (``ptrs``,
    bytes) and the output's 16-byte aligned, rows of ``d`` and ``mlp``
    floats multiples of 16 bytes -- else ``"ffma"`` (``csrc/mlp_tile.cuh``,
    true fp32). Geometry alone decides, before the launch; neither form
    stands in for the other when a build or a launch fails."""
    if not 0 < d <= MLP_F32_MAX_D or mlp <= 0:
        raise ValueError(f"fp32 mlp_block takes 0 < D <= {MLP_F32_MAX_D} "
                         f"and mlp > 0, got D={d}, mlp={mlp}")
    if d % 4 == 0 and mlp % 4 == 0 and all(p % 16 == 0 for p in ptrs):
        return "tf32"
    return "ffma"


def _check_mlp(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
               what: str, ln: str = "ln") -> int:
    """Check the MLP half's operands for the rows ``x`` (..., D) against
    K3's limits (``what`` names the caller in the errors, ``ln`` its norm's
    weights); return mlp."""
    d = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != d:
        raise ValueError(f"w1 shape {tuple(w1.shape)} does not take D={d}")
    mlp = w1.shape[1]
    for t, name, shape in ((ln_scale, f"{ln}_scale", (d,)),
                           (ln_bias, f"{ln}_bias", (d,)), (w1, "w1", (d, mlp)),
                           (b1, "b1", (mlp,)), (w2, "w2", (mlp, d)),
                           (b2, "b2", (d,))):
        _build.check_tensor(t, name, x, shape)
    if x.dtype == torch.bfloat16:
        if d % 128 or mlp % 128 or d > MLP_BF16_MAX_D:
            raise ValueError(f"bf16 {what} needs D and mlp multiples of 128 "
                             f"and D <= {MLP_BF16_MAX_D}; got D={d}, "
                             f"mlp={mlp}")
        _check_aligned(w1, "w1")
        _check_aligned(w2, "w2")
    elif d > MLP_F32_MAX_D:
        raise ValueError(f"fp32 {what} needs D <= {MLP_F32_MAX_D}, got {d}")
    return mlp


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 32:
        raise ValueError(f"{name} must be 32-byte aligned for the tensor-core "
                         "loads")


def mlp_block(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
              eps: float = 1e-12, partial_out: bool = False) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` on CUDA tensors in one kernel.
    ``x`` (..., D); ``w1`` (D, mlp); ``w2`` (mlp, D). ``partial_out=True``:
    the tensor-parallel shard form, ``fc2(gelu(fc1(LN(x))))`` with the
    accumulator seeded with zero, ``b2`` not read; it counts as
    ``mlp_block_partial``."""
    _build.check_tensor(x, "x", x)
    mlp = _check_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, "mlp_block")
    d = x.shape[-1]
    m = x.numel() // d
    if m == 0:
        raise ValueError(f"mlp_block of an empty tensor {tuple(x.shape)}")
    out = torch.empty_like(x)
    form = 0 if x.dtype == torch.bfloat16 else MLP_F32_FORMS[mlp_f32_form(
        d, mlp, (x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 out.data_ptr()))]
    _build.launch("vit_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2, out,
                  m, d, mlp, float(eps), int(partial_out), form, like=x)
    count_launch("mlp_block_partial" if partial_out else "mlp_block")
    return out


def attention_smem_bytes(seq: int, head_dim: int, itemsize: int) -> int:
    """Dynamic shared memory of one FFMA attention-core tile (K9's fp32
    attention phase, K23's fp32 core, K24): K (rows padded by one 4-byte word),
    V and the query tile in the input dtype, then the fp32 scores and row
    sums (``csrc/attention_core.cuh:attention_smem``). The gate
    :func:`vit_tpu_torch.ops.attn_plan` reads it in both dtypes."""
    pad = 4 // itemsize
    elems = seq * (head_dim + pad) + seq * head_dim + ATTN_QT * head_dim
    t = -(-elems * itemsize // 16) * 16
    return t + (ATTN_QT * seq + ATTN_QT) * 4


def attention_mma_smem_bytes(seq: int, head_dim: int) -> int:
    """Dynamic shared memory of one bf16 attention-core block on the tensor
    cores: K and V, ``seq`` rounded up to 16 rows, each row the head width
    rounded up to 16 columns plus 8 of padding
    (``csrc/attention_mma.cuh:attention_mma_smem``). It is below
    :func:`attention_smem_bytes` at every geometry that
    :func:`vit_tpu_torch.ops.attn_plan` admits in bf16."""
    rows = -(-seq // 16) * 16
    return 2 * rows * (-(-head_dim // 16) * 16 + 8) * 2


def attention_tf32_smem_bytes(seq: int, head_dim: int) -> int:
    """Dynamic shared memory of one fp32 attention-core block on the
    tensor cores: K and V, ``seq`` rounded up to 8 rows, each row the head
    width rounded up to 8 columns plus 4 of padding, in fp32
    (``csrc/attention_core.cuh:attention_tf32_smem``). It is at most
    :func:`attention_smem_bytes` at every geometry that
    :func:`vit_tpu_torch.ops.attn_plan` admits in fp32."""
    rows = -(-seq // 8) * 8
    return 2 * rows * (-(-head_dim // 8) * 8 + 4) * 4


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
    hd = d // num_heads
    smem = (attention_mma_smem_bytes(s, hd) if qkv.dtype == torch.bfloat16
            else attention_tf32_smem_bytes(s, hd))
    if smem > MAX_SMEM:
        raise ValueError(f"attention core needs {smem} B of shared memory "
                         f"at S={s}, more than {MAX_SMEM}")
    out = torch.empty((rows, d), dtype=qkv.dtype, device=qkv.device)
    _build.launch("vit_attention", qkv, out, batch, s, d, num_heads, seq_len,
                  float(scale), like=qkv)
    count_launch("attention")
    return out


def _check_attn(x: torch.Tensor, wqkv: torch.Tensor, num_heads: int) -> int:
    """Check ``x`` (B, S, D) and ``wqkv`` (D, 3*dl); return dl."""
    _build.check_tensor(x, "x", x)
    if x.dim() != 3:
        raise ValueError(f"x shape {tuple(x.shape)} is not (B, S, D)")
    if wqkv.dim() != 2 or wqkv.shape[1] % 3:
        raise ValueError(f"wqkv shape {tuple(wqkv.shape)} is not (D, 3*dl)")
    dl = wqkv.shape[1] // 3
    if num_heads <= 0 or dl % num_heads:
        raise ValueError(f"dl={dl} not divisible by {num_heads} heads")
    return dl


def _attn_ctx(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, *,
              num_heads: int, scale: float | None, seq_len: int | None,
              eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The first three launches of an attention half on a CUDA tensor ``x``
    (B, S, D), S already padded: K1, K2 into the packed ``(B*S, 3*dl)``
    ``[q|k|v]`` buffer (dl from ``wqkv``), then the attention core or,
    where :func:`vit_tpu_torch.ops.attn_plan` refuses the length, K7 over
    the buffer's head views. Returns ``(x (B*S, D), the (B*S, dl)
    context)``."""
    from vit_tpu_torch.ops import attn_plan

    dl = _check_attn(x, wqkv, num_heads)
    b, s, d = x.shape
    hd = dl // num_heads
    if scale is None:
        scale = hd ** -0.5
    if seq_len is None:
        seq_len = s
    xf = x.reshape(b * s, d)
    qkv = matmul(layernorm(xf, ln_scale, ln_bias, eps=eps), wqkv, bqkv)
    if attn_plan(b, s, dl, num_heads, x.dtype):
        ctx = attention_core(qkv, batch=b, num_heads=num_heads, scale=scale,
                             seq_len=seq_len)
    else:
        q, k, v = qkv.view(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
        # The kernel's context is a (B, S, H, hd) buffer: this is a view.
        ctx = flash_attention(q, k, v, scale=scale, seq_len=seq_len
                              ).transpose(1, 2).reshape(b * s, dl)
    return xf, ctx


def _attn_half(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
               *, num_heads: int, scale: float | None, seq_len: int | None,
               eps: float, residual: bool) -> torch.Tensor:
    """The launches of both attention halves: :func:`_attn_ctx`, then K2
    ``ctx @ wout`` (``+ bout``, ``+ x`` with ``residual``)."""
    xf, ctx = _attn_ctx(x, ln_scale, ln_bias, wqkv, bqkv, num_heads=num_heads,
                        scale=scale, seq_len=seq_len, eps=eps)
    return matmul(ctx, wout, bout, residual=xf if residual else None
                  ).reshape(x.shape)


def attn_block(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *,
               num_heads: int, scale: float | None = None,
               seq_len: int | None = None, eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHA(LN(x)))`` for a CUDA tensor ``x`` (B, S, D) with S
    already padded (keys at index >= ``seq_len`` are masked; query rows
    past it are computed and left for the caller to slice off)."""
    return _attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                      num_heads=num_heads, scale=scale, seq_len=seq_len,
                      eps=eps, residual=True)


def attn_block_partial(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout,
                       *, num_heads: int, scale: float | None = None,
                       seq_len: int | None = None,
                       eps: float = 1e-12) -> torch.Tensor:
    """``proj_s(MHA_s(LN(x)))`` for a CUDA tensor ``x`` (B, S, D), S already
    padded: one tensor-parallel shard's attention half, with ``num_heads``
    the shard's heads, ``wqkv`` (D, 3*dl) its head-major ``[q_s|k_s|v_s]``
    columns, ``bqkv`` (3*dl,) and ``wout`` (dl, D) its rows. No bias and no
    residual; the result is in ``x.dtype``."""
    return _attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, None,
                      num_heads=num_heads, scale=scale, seq_len=seq_len,
                      eps=eps, residual=False)


def _check_tail(x: torch.Tensor, wout, bout, ln2_scale, ln2_bias, w1, b1,
                w2, b2) -> int:
    """Check K18's operands for the input rows ``x`` (..., D); return
    mlp."""
    # K18's width limits are K3's: in bf16 it is K3's tile, and in fp32
    # its ctx, y and chunk rows fill 208 KB of shared memory at D=1536.
    mlp = _check_mlp(x, ln2_scale, ln2_bias, w1, b1, w2, b2, "layer_block",
                     ln="ln2")
    d = x.shape[-1]
    _build.check_tensor(wout, "wout", x, (d, d))
    _build.check_tensor(bout, "bout", x, (d,))
    if x.dtype == torch.bfloat16:
        _check_aligned(wout, "wout")
    return mlp


def layer_tail(ctx: torch.Tensor, x: torch.Tensor, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2, *,
               eps: float = 1e-12) -> torch.Tensor:
    """K18 alone on CUDA tensors: from the attention context ``ctx`` (M, D)
    and the layer's input rows ``x`` (M, D), ``y = ctx @ wout + bout + x``
    kept in fp32, then ``y + b2 + fc2(gelu(fc1(LN2 y)))``, cast once.
    Counted as ``layer_block``."""
    _build.check_tensor(x, "x", x)
    if x.dim() != 2:
        raise ValueError(f"x shape {tuple(x.shape)} is not (M, D)")
    _build.check_tensor(ctx, "ctx", x, tuple(x.shape))
    if x.dtype == torch.bfloat16 and ctx.data_ptr() % 16:
        raise ValueError("ctx must be 16-byte aligned for its TMA boxes")
    mlp = _check_tail(x, wout, bout, ln2_scale, ln2_bias, w1, b1, w2, b2)
    m, d = x.shape
    if m == 0:
        raise ValueError("layer_block of an empty tensor")
    out = torch.empty_like(x)
    _build.launch("vit_layer_block", ctx, x, wout, bout, ln2_scale, ln2_bias,
                  w1, b1, w2, b2, out, m, d, mlp, float(eps), like=x)
    count_launch("layer_block")
    return out


def layer_block(x: torch.Tensor, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                ln2_scale, ln2_bias, w1, b1, w2, b2, *, num_heads: int,
                scale: float | None = None, seq_len: int | None = None,
                eps: float = 1e-12) -> torch.Tensor:
    """A full encoder layer on a CUDA tensor ``x`` (B, S, D), S already
    padded, in four launches: :func:`_attn_ctx`'s three (K1, K2, the
    attention core or K7), then K18 (:func:`layer_tail`), which runs the
    out-projection and the MLP half with the activation between them in
    fp32 on chip. Only K18 counts as ``layer_block``. Every operand is
    checked before the first launch."""
    dl = _check_attn(x, wqkv, num_heads)
    d = x.shape[-1]
    if dl != d:
        raise ValueError(f"wqkv shape {tuple(wqkv.shape)} is not (D, 3D) "
                         f"for D={d}")
    for t, name, shape in ((ln1_scale, "ln1_scale", (d,)),
                           (ln1_bias, "ln1_bias", (d,)),
                           (wqkv, "wqkv", (d, 3 * d)),
                           (bqkv, "bqkv", (3 * d,))):
        _build.check_tensor(t, name, x, shape)
    _check_tail(x, wout, bout, ln2_scale, ln2_bias, w1, b1, w2, b2)
    xf, ctx = _attn_ctx(x, ln1_scale, ln1_bias, wqkv, bqkv,
                        num_heads=num_heads, scale=scale, seq_len=seq_len,
                        eps=eps)
    return layer_tail(ctx, xf, wout, bout, ln2_scale, ln2_bias, w1, b1, w2,
                      b2, eps=eps).reshape(x.shape)
