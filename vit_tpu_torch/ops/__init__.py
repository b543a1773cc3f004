"""Public op library for the slice (counterpart of ``vit_tpu/ops/__init__.py``).

Every op takes ``impl="torch" | "cuda" | None`` (see
:mod:`vit_tpu_torch.ops.dispatch`): ``None`` runs the hand-written kernel
for a CUDA tensor and the plain PyTorch version for a CPU tensor.

The float ops are differentiable. With ``impl="torch"`` PyTorch's autograd
differentiates the plain versions (the oracle); otherwise each op is a
``torch.autograd.Function`` of :mod:`vit_tpu_torch.ops.autograd`, whose
backward is JAX's custom VJP for the op (``vit_tpu/ops/pallas/vjp.py``)
with its kernel slots filled by device. The int8 ops and
``layernorm_stats`` are not differentiable, as in JAX, and neither are the
tensor-parallel shard forms (``attn_block_partial``,
``attn_block_q_partial``, ``partial_out=True``): JAX defines no VJP for
them, so they run under ``torch.no_grad``.

:func:`attn_plan` and :func:`mlp_plan` say whether a half-block
mega-kernel takes a geometry; the model routes each half of a layer by
them (``vit_tpu_torch/models/vit.py:encoder_block``), and the attention
halves choose between the attention core and K7 by :func:`attn_plan`.
:func:`layer_plan` says whether the full-layer kernel takes a geometry,
where the model is asked for it (``layer_block=True``).
:func:`mlp_q_plan` says whether the int8 MLP kernels take one
(``quant.py``, ``parallel/tp.py``). :func:`stack_plan`,
:func:`stack_fused_plan` and :func:`embed_fused_ok` pick the small-batch
route (``vit_tpu_torch/models/vit.py:forward``); :func:`stack_q_plan`
the int8 tier's (``vit_tpu_torch/quant.py:forward_quant``). They read
geometry and dtype only, never the device, so the plain versions on the
CPU walk the same op sequence as the kernels on the card.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import autograd, reference
from vit_tpu_torch.ops.dispatch import check_impl, kernel_fn, resolve_impl

__all__ = [
    "layernorm", "layernorm_stats", "matmul", "fused_linear", "patchify",
    "patch_embed", "add", "softmax", "matmul3", "flash_attention",
    "flash_attention_qkv", "flash_attention_bwd", "attn_block",
    "mlp_block", "layer_block", "attn_plan", "mlp_plan", "layer_plan",
    "mlp_q_plan", "embed_fused",
    "embed_fused_ok",
    "encoder_stack",
    "encoder_stack_fused", "stack_plan", "stack_fused_plan", "quantize_rows",
    "matmul_i8", "attn_block_q", "mlp_block_i8dot", "mlp_block_q",
    "encoder_stack_q", "stack_q_plan", "attn_block_partial",
    "attn_block_q_partial", "resolve_impl", "reference",
]


def layernorm(x, scale, bias, *, eps=1e-12, impl=None):
    """Row layernorm over the last dim (kernel K1)."""
    if check_impl(impl) == "torch":
        return reference.layernorm(x, scale, bias, eps=eps)
    return autograd.run(autograd.LayerNorm, x, scale, bias, eps, impl)


def layernorm_stats(x, *, eps=1e-12, impl=None):
    """Row mean and ``rsqrt(var + eps)`` as two ``(M, 1)`` fp32 tensors
    (kernel K5)."""
    return kernel_fn("layernorm_stats", impl, x)(x, eps=eps)


def matmul(x, w, bias=None, activation=None, *, residual=None, impl=None):
    """``(..., K) @ (K, N)`` + bias, GELU, + residual (kernel K2)."""
    if check_impl(impl) == "torch":
        return reference.matmul(x, w, bias, activation, residual)
    return autograd.run(autograd.Linear, x, w, bias, residual, activation,
                        impl)


def fused_linear(x, w, bias=None, activation=None, *, ln_scale=None,
                 ln_bias=None, eps=1e-12, residual=None, impl=None):
    """``act(LN(x) @ w + bias) + residual`` (K5 then K6 with LN; K2
    without)."""
    if check_impl(impl) == "torch":
        return reference.fused_linear(x, w, bias, activation,
                                      ln_scale=ln_scale, ln_bias=ln_bias,
                                      eps=eps, residual=residual)
    return autograd.run(autograd.FusedLinear, x, w, bias, ln_scale, ln_bias,
                        residual, activation, eps, impl)


def add(x, y, *, impl=None):
    """``x + y`` of one shape and dtype (kernel K14): the residual of the
    ``fused=False`` chain."""
    if check_impl(impl) == "torch":
        return reference.add(x, y)
    return autograd.run(autograd.Add, x, y, impl)


def softmax(x, *, impl=None):
    """Row softmax over the last dim in fp32, cast once (kernel K15)."""
    if check_impl(impl) == "torch":
        return reference.softmax(x)
    return autograd.run(autograd.Softmax, x, impl)


def matmul3(x, y, *, scale=None, impl=None):
    """``(B, M, K) @ (B, K, N)`` times ``scale`` (kernel K16): the unfused
    attention's scores and context. The kernel takes contiguous operands;
    its backward copies the transposes it needs."""
    if check_impl(impl) == "torch":
        return reference.matmul3(x, y, scale=scale)
    return autograd.run(autograd.Matmul3, x, y, scale, impl)


def flash_attention(q, k, v, *, scale=None, seq_len=None, out_dtype=None,
                    impl=None):
    """Softmax attention in (B, H, S, d) layout, keys at index >= ``seq_len``
    masked (kernel K7). ``q``, ``k`` and ``v`` may be strided views; the
    result is in ``out_dtype`` (default ``q.dtype``, or fp32). An fp32
    result of lower-precision inputs (the int8 tier's) is not
    differentiable. Where a gradient is wanted, q, k and v are packed into
    one buffer for :func:`flash_attention_qkv`; a caller that holds the
    packed QKV projection calls that directly."""
    if check_impl(impl) == "torch":
        return reference.flash_attention(q, k, v, scale=scale,
                                         seq_len=seq_len, out_dtype=out_dtype)
    if (out_dtype in (None, q.dtype) and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2)
        return flash_attention_qkv(qkv, scale=scale, seq_len=seq_len,
                                   impl=impl)
    return kernel_fn("flash_attention", impl, q)(
        q, k, v, scale=scale, seq_len=seq_len, out_dtype=out_dtype)


def flash_attention_qkv(qkv, *, scale=None, seq_len=None, impl=None):
    """:func:`flash_attention` over the heads of a packed ``(B, S, 3, H, d)``
    QKV buffer, returning ``(B, H, S, d)``; differentiable, its backward on
    K13, whose packed gradient is the buffer's as it stands."""
    if check_impl(impl) == "torch":
        return reference.flash_attention(*reference.split_qkv(qkv),
                                         scale=scale, seq_len=seq_len)
    return autograd.run(
        autograd.Attention, qkv,
        qkv.shape[-1] ** -0.5 if scale is None else scale,
        qkv.shape[1] if seq_len is None else seq_len, impl)


def flash_attention_bwd(q, k, v, g, *, scale=None, seq_len=None, impl=None):
    """The gradients of :func:`flash_attention` for the output gradient
    ``g`` (kernel K13, two launches): the packed ``(B, S, 3, H, d)`` buffer
    ``[dq | dk | dv]`` (``reference.split_qkv`` splits it)."""
    return kernel_fn("flash_attention_bwd", impl, q)(q, k, v, g, scale=scale,
                                                     seq_len=seq_len)


@torch.no_grad()
def patchify(x, patch_size, *, impl=None):
    """``(B, C, H, W) -> (B, (H/P)*(W/P), C*P*P)`` in (c, kh, kw) order
    (kernel K19), bit for bit. Not differentiable, as JAX's Pallas
    ``patchify`` is not. The models leave the unfold to the layout copy
    ``reference.patchify``, as JAX's leave it to XLA
    (``vit_tpu/models/vit.py:108, 287``)."""
    return kernel_fn("patchify", impl, x)(x, patch_size)


def patch_embed(x, w, bias, patch_size, *, impl=None):
    """Patch-embedding convolution as unfold + matmul, as on the JAX Pallas
    tier (``vit_tpu/ops/pallas/patch_embed.py:30-44``): the unfold is the
    layout copy ``reference.patchify``, the projection runs on K2."""
    return matmul(reference.patchify(x, patch_size), w, bias, impl=impl)


def mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps=1e-12,
              partial_out=False, impl=None):
    """``x + fc2(gelu(fc1(LN(x))))``, one kernel (K3). ``partial_out=True``
    is the tensor-parallel shard form (``w1``/``w2`` this shard's MLP
    columns, no residual, ``b2`` ignored), not differentiable."""
    if partial_out:
        with torch.no_grad():
            return kernel_fn("mlp_block", impl, x)(
                x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
                partial_out=True)
    if check_impl(impl) == "torch":
        return reference.mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                   eps=eps)
    return autograd.run(autograd.MlpBlock, x, ln_scale, ln_bias, w1, b1, w2,
                        b2, eps, impl)


def attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *, num_heads,
               scale=None, seq_len=None, eps=1e-12, impl=None):
    """``x + proj(MHA(LN(x)))`` for ``x`` (B, S, D) (K4: K1, K2, the
    attention core, K2)."""
    if check_impl(impl) == "torch":
        return reference.attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wout,
                                    bout, num_heads=num_heads, scale=scale,
                                    seq_len=seq_len, eps=eps)
    b, s, d = x.shape
    return autograd.run(
        autograd.AttnBlock, x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
        num_heads,
        (d // num_heads) ** -0.5 if scale is None else scale,
        s if seq_len is None else seq_len, eps, impl)


def layer_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                ln2_bias, w1, b1, w2, b2, *, num_heads, scale=None,
                seq_len=None, eps=1e-12, impl=None):
    """A full encoder layer, :func:`attn_block` then :func:`mlp_block` with
    the activation between them kept in fp32 (B18: K1, K2, the attention
    core or K7, then K18). Its backward recomputes through the two composed
    halves (``vit_tpu/ops/pallas/vjp.py:layer_block``)."""
    if check_impl(impl) == "torch":
        return reference.layer_block(
            x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
            ln2_bias, w1, b1, w2, b2, num_heads=num_heads, scale=scale,
            seq_len=seq_len, eps=eps)
    b, s, d = x.shape
    return autograd.run(
        autograd.LayerBlock, x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
        ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
        (d // num_heads) ** -0.5 if scale is None else scale,
        s if seq_len is None else seq_len, eps, impl)


@torch.no_grad()
def attn_block_partial(x, ln_scale, ln_bias, wqkv, bqkv, wout, *, num_heads,
                       scale=None, seq_len=None, eps=1e-12, impl=None):
    """``proj_s(MHA_s(LN(x)))``, one tensor-parallel shard's attention half
    (B16): ``num_heads`` the shard's heads, ``wqkv`` (D, 3*dl) its
    head-major ``[q_s|k_s|v_s]`` columns, ``wout`` (dl, D) its rows; no
    bias, no residual, a partial sum in ``x.dtype`` (K1, K2, the attention
    core or, where :func:`attn_plan` refuses the length, K7, then K2)."""
    return kernel_fn("attn_block_partial", impl, x)(
        x, ln_scale, ln_bias, wqkv, bqkv, wout, num_heads=num_heads,
        scale=scale, seq_len=seq_len, eps=eps)


def attn_plan(batch: int, seq_pad: int, hidden: int, num_heads: int,
              dtype: torch.dtype) -> bool:
    """Whether ``attn_block`` takes this geometry: the FFMA attention core
    keeps a head's whole K, V and score rows in one block's shared memory.
    The bf16 core on the tensor cores needs less at every geometry this
    admits (``ops/cuda/block.py:attention_mma_smem_bytes``), so the gate
    stays the FFMA tile's in both dtypes. The batch does not matter to the
    port's kernels (counterpart of ``vit_tpu.ops.attn_plan``)."""
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


def layer_plan(batch: int, seq_pad: int, hidden: int, mlp: int,
               num_heads: int, dtype: torch.dtype) -> bool:
    """Whether :func:`layer_block` takes this geometry (counterpart of
    ``vit_tpu.ops.layer_plan``): both half plans (:func:`attn_plan`,
    :func:`mlp_plan`, whose width limits K18 shares) with D and mlp
    multiples of 128. It reads the port's own kernel limits, not JAX's
    22 MB VMEM budget (``block.py:1744-1753``), which refuses B/16 fp32 and
    L/16 bf16; K18 takes both. The batch does not matter to the port's
    kernels. JAX's plan is opt-in; the model's ``layer_block=True`` is the
    opt-in (ROADMAP C)."""
    return (hidden % 128 == 0 and mlp % 128 == 0 and hidden % num_heads == 0
            and attn_plan(batch, seq_pad, hidden, num_heads, dtype)
            and mlp_plan(hidden, mlp, dtype))


def mlp_q_plan(hidden: int, mlp: int) -> bool:
    """Whether the int8 MLP kernels (K12 ``mlp_block_i8dot``, K17
    ``mlp_block_q``) take this geometry: D a multiple of 128 up to 1280 and
    ``mlp`` whole :data:`reference.MLP_GROUP`-column quant groups."""
    from vit_tpu_torch.ops.cuda.quant import MLP_I8_MAX_D
    return (hidden % 128 == 0 and hidden <= MLP_I8_MAX_D
            and mlp % reference.MLP_GROUP == 0)


def embed_fused(patches, w, bias, cls_row, pos, sp, *, impl=None):
    """Patch projection + CLS row + positions + zero pad to ``sp`` rows in
    one kernel (K8): ``(B, N, K) -> (B, sp, D)``."""
    if check_impl(impl) == "torch":
        return reference.embed_fused(patches, w, bias, cls_row, pos, sp)
    return autograd.run(autograd.EmbedFused, patches, w, bias, cls_row, pos,
                        sp, impl)


def encoder_stack(x, enc, *, num_heads, scale=None, seq_len=None, eps=1e-12,
                  impl=None):
    """The whole stacked encoder on ``x`` (B, sp, D) in one kernel (K9)."""
    if check_impl(impl) == "torch":
        return reference.encoder_stack(x, enc, num_heads=num_heads,
                                       scale=scale, seq_len=seq_len, eps=eps)
    b, s, d = x.shape
    return autograd.run(
        autograd.EncoderStack, x, num_heads,
        (d // num_heads) ** -0.5 if scale is None else scale,
        s if seq_len is None else seq_len, eps, impl,
        *autograd.enc_leaves(enc))


def encoder_stack_fused(patches, enc, wemb, base, lnf, *, num_heads, sp,
                        scale=None, seq_len=None, eps=1e-12, impl=None):
    """Patch embed + the whole encoder + the final LN in one kernel (K9,
    embed and final LN folded): ``(B, N, K) -> (B, sp, D)``."""
    if check_impl(impl) == "torch":
        return reference.encoder_stack_fused(
            patches, enc, wemb, base, lnf, num_heads=num_heads, sp=sp,
            scale=scale, seq_len=seq_len, eps=eps)
    d = wemb.shape[1]
    return autograd.run(
        autograd.EncoderStackFused, patches, wemb, base, lnf["scale"],
        lnf["bias"], num_heads, sp,
        (d // num_heads) ** -0.5 if scale is None else scale,
        patches.shape[1] + 1 if seq_len is None else seq_len, eps, impl,
        *autograd.enc_leaves(enc))


def embed_fused_ok(b: int, n: int, d: int, sp: int,
                   num_prefix_tokens: int) -> bool:
    """Whether the model embeds through :func:`embed_fused` (counterpart of
    ``vit_tpu.ops.embed_fused_ok`` and the gate around it in
    ``vit_tpu/models/vit.py:embed``): one prefix token, D a multiple of
    128, a padded token count (``sp > n + 1``) and a batch of at most 4,
    the bound JAX measured its gain under. JAX's VMEM model, the one
    reader of the patch length and the dtype there, is dropped: it accepts
    every variant in both dtypes, and the port's kernel keeps nothing
    resident, so it takes any patch length."""
    return (num_prefix_tokens == 1 and d % 128 == 0 and sp > n + 1
            and b <= 4)


def stack_plan(b: int, sp: int, d: int, mlp: int, num_heads: int,
               dtype: torch.dtype) -> bool:
    """Whether the model runs the whole encoder as :func:`encoder_stack`.

    This mirrors where the JAX package took the stack on the TPU, not a
    measurement on the H100: its untuned rule, bf16 B/16-class widths
    (D=768, MLP 3072) at batch <= 2 (``vit_tpu/ops/pallas/block.py:
    2083-2103``), and the one other ``encstack`` row of its tuned table,
    L/16 at 208 tokens and batch 1. The kernel's attention phase is the
    attention core's routine, so :func:`attn_plan` must take the geometry
    too (a 768-wide model at 384 px, 592 tokens, it does not)."""
    if dtype != torch.bfloat16 or d % num_heads or not attn_plan(
            b, sp, d, num_heads, dtype):
        return False
    return ((d, mlp) == (768, 3072) and b <= 2) or (
        (sp, d, mlp) == (208, 1024, 4096) and b == 1)


def stack_fused_plan(b: int, sp: int, d: int, mlp: int, num_heads: int,
                     dtype: torch.dtype, num_prefix_tokens: int) -> bool:
    """Whether the model runs patch embed, encoder and final LN as
    :func:`encoder_stack_fused`: :func:`stack_plan` and one prefix token
    (the fold writes one CLS row an image). JAX's VMEM model, which
    refuses the fold for L/16 at batch 1 (the resident patches and embed
    weight overflow the TPU's 28 MB budget), is dropped: the kernel keeps
    nothing resident."""
    return num_prefix_tokens == 1 and stack_plan(b, sp, d, mlp, num_heads,
                                                 dtype)


# ------------------------------------------------------------------ int8 --

def quantize_rows(x, *, ln_scale=None, ln_bias=None, eps=1e-12, impl=None):
    """Per-row symmetric int8 of ``x`` (..., D), optionally after an fp32
    LN: ``(xq (M, D) int8, ax (M, 1) fp32)`` (kernel K10)."""
    return kernel_fn("quantize_rows", impl, x)(
        x, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps)


def matmul_i8(xq, ax, wq, wscale, bias=None, activation=None, *,
              residual=None, out_dtype, impl=None):
    """``(xq @ wq) * ax * wscale`` + bias, GELU, + residual, the product
    s8 x s8 -> s32 (kernel K11)."""
    return kernel_fn("matmul_i8", impl, xq)(
        xq, ax, wq, wscale, bias, activation, residual=residual,
        out_dtype=out_dtype)


def attn_block_q(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q, sout, bout,
                 *, num_heads, scale=None, seq_len=None, eps=1e-12,
                 impl=None):
    """``x + proj(MHA(LN(x)))`` with int8 projections (five launches: K10,
    K11, K7 with an fp32 output, K10, K11)."""
    return kernel_fn("attn_block_q", impl, x)(
        x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q, sout, bout,
        num_heads=num_heads, scale=scale, seq_len=seq_len, eps=eps)


@torch.no_grad()
def attn_block_q_partial(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q,
                         sout, *, num_heads, scale=None, seq_len=None,
                         eps=1e-12, impl=None):
    """:func:`attn_block_partial` with int8 projections (B17; five
    launches: K10, K11, K7 with an fp32 output, K10 over the shard's
    ``dl`` context columns, K11 with no bias and no residual)."""
    return kernel_fn("attn_block_q_partial", impl, x)(
        x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q, sout,
        num_heads=num_heads, scale=scale, seq_len=seq_len, eps=eps)


def mlp_block_i8dot(x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, *,
                    eps=1e-12, partial_out=False, impl=None):
    """``x + fc2(gelu(fc1(LN(x))))`` with both products s8 x s8 -> s32 and
    the hidden requantized every 512 columns, one kernel (K12);
    ``partial_out`` as in :func:`mlp_block`."""
    return kernel_fn("mlp_block_i8dot", impl, x)(
        x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, eps=eps,
        partial_out=partial_out)


def mlp_block_q(x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, *,
                eps=1e-12, partial_out=False, impl=None):
    """``x + fc2(gelu(fc1(LN(x))))`` on weight-only int8 weights, the
    activations in float, one kernel (K17); ``partial_out`` as in
    :func:`mlp_block`."""
    return kernel_fn("mlp_block_q", impl, x)(
        x, ln_scale, ln_bias, w1q, s1, b1, w2q, s2, b2, eps=eps,
        partial_out=partial_out)


def encoder_stack_q(x, enc, *, num_heads, scale=None, seq_len=None,
                    eps=1e-12, impl=None):
    """The whole encoder on weight-only int8 weights in one kernel (K9 with
    int8 weight tiles)."""
    return kernel_fn("encoder_stack_q", impl, x)(
        x, enc, num_heads=num_heads, scale=scale, seq_len=seq_len, eps=eps)


def stack_q_plan(b: int, sp: int, d: int, mlp: int, num_heads: int,
                 dtype: torch.dtype) -> bool:
    """Whether ``forward_quant`` runs the whole encoder as
    :func:`encoder_stack_q` (counterpart of
    ``vit_tpu/ops/pallas/block.py:encoder_stack_plan_q``). It mirrors where
    the JAX package took the int8 stack on the TPU, not a measurement on
    the H100: its tuned ``encstackq`` rows pin 208 tokens at batch 1 to the
    stack and at batch 2 to the per-layer route; other geometries fall
    back to the float rule, :func:`stack_plan`."""
    return stack_plan(b, sp, d, mlp, num_heads, dtype) and not (
        b == 2 and sp == 208)
