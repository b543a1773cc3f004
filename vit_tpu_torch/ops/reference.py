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
- ``layer_block`` keeps the sum between its halves in fp32: LN2 reads it
  unrounded and the MLP accumulator starts at it plus ``b2``
  (``block.py:1701-1720``);
- ``mlp_block`` seeds its fp32 accumulator with ``x + b2``
  (``block.py:77-78``; with zero in the tensor-parallel ``partial_out``
  form) and rounds the GELU hidden to the input dtype before the second
  product (``block.py:86``);
- the tensor-parallel attention partials (``attn_block_partial``,
  ``attn_block_q_partial``) round where the whole blocks do and end in
  ``x.dtype`` with no bias and no residual (``block.py:697-698, 1067,
  1497``);
- ``fused_linear`` normalises x with the fp32 row stats of
  ``layernorm_stats`` and rounds it to the input dtype before the product
  (``vit_tpu/ops/pallas/matmul.py:250-257``);
- ``encoder_stack_fused`` rounds the patch rows and the last layer's MLP
  sum once fewer than the composed route, as its kernel does (its
  docstring says where);
- the int8 kernels (end of the module) quantize fp32 values: the LN
  output and the attention context are not rounded to the dtype first;
  the weight-only ``mlp_block_q`` quantizes nothing and rounds where
  ``mlp_block`` does.
"""

from __future__ import annotations

import torch


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-form GELU: 0.5 * x * (1 + erf(x / sqrt(2)))."""
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


_INV_SQRT_2PI = 0.3989422804014327


def gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of the erf-form GELU: ``Phi(z) + z phi(z)``
    (``vit_tpu/ops/pallas/vjp.py:gelu_grad``)."""
    phi = _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
    return 0.5 * (1.0 + torch.erf(z * (2.0 ** -0.5))) + z * phi


def layernorm_grad(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                   eps: float = 1e-12):
    """The layernorm backward in fp32 (``vit_tpu/ops/pallas/vjp.py:
    179-195``): for rows ``x`` (..., D) and the output gradient ``g``,
    ``(dx in x.dtype, dscale, dbias)``, the last two fp32 sums over the
    rows, left in fp32 for the caller to cast."""
    d = x.shape[-1]
    x32 = _f32(x).reshape(-1, d)
    g32 = _f32(g).reshape(-1, d)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dxhat = g32 * _f32(scale)
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype).reshape(x.shape), (g32 * xhat).sum(dim=0),
            g32.sum(dim=0))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-12) -> torch.Tensor:
    """Row layernorm over the last dim: fp32 stats, biased variance, eps
    inside the sqrt; output in the input dtype."""
    x32 = _f32(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * _f32(scale) + _f32(bias)).to(x.dtype)


def layernorm_stats(x: torch.Tensor, *,
                    eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """Row mean and ``rsqrt(var + eps)`` of ``(..., D)`` as two ``(M, 1)``
    fp32 tensors (rows flattened), with the centred, biased variance of
    ``vit_tpu/ops/pallas/layernorm.py:_stats_kernel``."""
    x32 = _f32(x).reshape(-1, x.shape[-1])
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           activation: str | None = None,
           residual: torch.Tensor | None = None, *,
           wscale: torch.Tensor | None = None) -> torch.Tensor:
    """``(..., K) @ (K, N)`` in fp32, then ``+ bias``, then GELU, then
    ``+ residual`` (all fp32), rounded once to ``x.dtype``. ``w`` is
    ``(in, out)``, the transpose of ``nn.Linear``'s layout. With
    ``wscale`` (N,) fp32, ``w`` holds int8 codes of a weight-only quantized
    weight and the product is scaled per column before the bias:
    ``(x @ w) * wscale + bias``, the order of
    ``vit_tpu/ops/pallas/block.py:_encoder_stack_q_kernel``."""
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    out = torch.matmul(_f32(x), _f32(w))
    if wscale is not None:
        out = out * wscale
    if bias is not None:
        out = out + _f32(bias)
    if activation == "gelu":
        out = gelu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    if residual is not None:
        out = out + _f32(residual)
    return out.to(x.dtype)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` of two tensors of one shape and dtype, no broadcasting
    (``vit_tpu/ops/pallas/add.py:add``): one rounding to the dtype."""
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"add of {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(y.shape)} {y.dtype}")
    return x + y


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim in fp32, cast once to the input dtype
    (``vit_tpu/ops/pallas/softmax.py:_softmax_kernel``): the row max
    subtracted, ``exp``, divided by the row sum."""
    x32 = _f32(x)
    e = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def matmul3(x: torch.Tensor, y: torch.Tensor, *,
            scale: float | None = None) -> torch.Tensor:
    """``(B, M, K) @ (B, K, N)`` summed in fp32, times ``scale``, cast once
    to ``x.dtype`` (``vit_tpu/ops/pallas/matmul3.py``: both its group and
    its general kernel compute this)."""
    if (x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0]
            or x.shape[2] != y.shape[1]):
        raise ValueError(f"matmul3 shapes {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    out = torch.matmul(_f32(x), _f32(y))
    if scale is not None:
        out = out * scale
    return out.to(x.dtype)


def fused_linear(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 activation: str | None = None, *,
                 ln_scale: torch.Tensor | None = None,
                 ln_bias: torch.Tensor | None = None, eps: float = 1e-12,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(LN(x) @ w + bias) + residual``: :func:`matmul` on
    ``((x - mu) * rstd * ln_scale + ln_bias)`` computed in fp32 from
    :func:`layernorm_stats` and rounded to ``x.dtype``
    (``vit_tpu/ops/pallas/matmul.py:_fused_linear_kernel``)."""
    if ln_scale is not None:
        mu, rstd = layernorm_stats(x, eps=eps)
        xn = (_f32(x).reshape(mu.shape[0], -1) - mu) * rstd
        xn = xn * _f32(ln_scale) + _f32(ln_bias)
        x = xn.to(x.dtype).reshape(x.shape)
    return matmul(x, w, bias, activation, residual)


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
              scale: float | None = None, seq_len: int | None = None,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Softmax attention in (B, H, S, d) layout with the Pallas kernel's
    rounding: fp32 scores, keys at index >= ``seq_len`` set to -inf,
    ``p = exp(s - max)``, ``ctx = (p in dtype) @ v / rowsum(p)``, cast to
    ``out_dtype`` (default ``q.dtype``; the int8 attention keeps it fp32,
    ``block.py:1249-1250``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(_f32(q), _f32(k).transpose(-1, -2)) * scale
    if seq_len is not None and seq_len != k.shape[-2]:
        keep = torch.arange(k.shape[-2], device=k.device) < seq_len
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(_f32(p.to(q.dtype)), _f32(v)) / l
    return ctx.to(out_dtype or q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, seq_len: int | None = None,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """:func:`attention` under the JAX op's name; ``q``, ``k`` and ``v`` may
    be strided ``(B, H, S, d)`` views, such as the heads of a packed QKV
    buffer. The plain version of ``csrc/flash_attention.cu``, which takes
    its softmax relative to a running max instead of the row max."""
    return attention(q, k, v, scale=scale, seq_len=seq_len,
                     out_dtype=out_dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, *, scale: float | None = None,
                        seq_len: int | None = None) -> torch.Tensor:
    """The gradients of :func:`flash_attention` for the output gradient
    ``g``, with the rounding of ``vit_tpu/ops/pallas/vjp.py:
    _flash_bwd_group_kernel``: ``p = exp(s - rowmax) / rowsum`` in fp32 from
    the fp32 scores (keys >= ``seq_len`` at -inf), ``dv = (p in dtype)^T
    g``, ``dp = g v^T``, ``ds = p * (dp - rowsum(dp * p))``, ``dq = (ds in
    dtype) k * scale`` and ``dk = (ds in dtype)^T q * scale``, each product
    summed in fp32 and cast once to ``q.dtype``.

    Returns the packed ``(B, S, 3, H, d)`` buffer ``[dq | dk | dv]`` that a
    ``(B*S, 3D)`` QKV projection's gradient is (:func:`split_qkv` gives the
    three ``(B, H, S, d)`` views), as the kernel writes it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    s = torch.matmul(_f32(q), _f32(k).transpose(-1, -2)) * scale
    if seq_len is not None and seq_len != k.shape[-2]:
        keep = torch.arange(k.shape[-2], device=k.device) < seq_len
        s = s.masked_fill(~keep, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(_f32(p.to(dt)).transpose(-1, -2), _f32(g))
    dp = torch.matmul(_f32(g), _f32(v).transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = _f32(ds.to(dt))
    dq = torch.matmul(ds, _f32(k)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _f32(q)) * scale
    return torch.stack([t.to(dt).transpose(1, 2) for t in (dq, dk, dv)], 2)


def split_qkv(qkv: torch.Tensor):
    """The three ``(B, H, S, d)`` views of a packed ``(B, S, 3, H, d)``
    buffer: q, k and v of a QKV projection, or ``(dq, dk, dv)`` of
    :func:`flash_attention_bwd`."""
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


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


def _attn_ctx(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, *,
              num_heads: int, scale: float | None, seq_len: int | None,
              eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x (B*S, D), the (B*S, dl) context)`` for ``x`` (B, S, D), dl from
    ``wqkv``, rounded as ``vit_tpu/ops/pallas/block.py:_attn_core`` rounds:
    LN, q/k/v and the concatenated context in the input dtype."""
    b, s, d = x.shape
    dl = wqkv.shape[1] // 3
    if scale is None:
        scale = (dl // num_heads) ** -0.5
    if seq_len is None:
        seq_len = s
    xf = x.reshape(b * s, d)
    qkv = matmul(layernorm(xf, ln_scale, ln_bias, eps=eps), wqkv, bqkv)
    return xf, attention_core(qkv, batch=b, num_heads=num_heads, scale=scale,
                              seq_len=seq_len)


def _attn_half(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *,
               num_heads: int, scale: float | None, seq_len: int | None,
               eps: float, residual: bool) -> torch.Tensor:
    """Both attention halves for ``x`` (B, S, D): :func:`_attn_ctx`, then
    the output projection adds ``bout`` and, with ``residual``, ``x`` in
    fp32 before one cast."""
    xf, ctx = _attn_ctx(x, ln_scale, ln_bias, wqkv, bqkv, num_heads=num_heads,
                        scale=scale, seq_len=seq_len, eps=eps)
    return matmul(ctx, wout, bout,
                  residual=xf if residual else None).reshape(x.shape)


def attn_block(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout, bout, *,
               num_heads: int, scale: float | None = None,
               seq_len: int | None = None, eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHA(LN(x)))`` for ``x`` (B, S, D), rounded as
    :func:`_attn_half` says."""
    return _attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                      num_heads=num_heads, scale=scale, seq_len=seq_len,
                      eps=eps, residual=True)


def _mlp_acc(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
             eps: float, partial_out: bool = False) -> torch.Tensor:
    """:func:`mlp_block` before its final cast: the fp32 accumulator."""
    h = matmul(layernorm(x, ln_scale, ln_bias, eps=eps), w1, b1, "gelu")
    prod = torch.matmul(_f32(h), _f32(w2))
    return prod if partial_out else _f32(x) + _f32(b2) + prod


def mlp_block(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
              eps: float = 1e-12, partial_out: bool = False) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` with the Pallas kernel's rounding: LN
    and the GELU hidden in the input dtype, the fp32 accumulator seeded
    with ``x + b2``. ``partial_out=True`` is the tensor-parallel shard form
    (``block.py:199-202``): ``w1``/``w2`` hold this shard's MLP columns,
    the accumulator starts at zero and ``b2`` is ignored."""
    return _mlp_acc(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
                    partial_out=partial_out).to(x.dtype)


def layer_block(x: torch.Tensor, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                ln2_scale, ln2_bias, w1, b1, w2, b2, *, num_heads: int,
                scale: float | None = None, seq_len: int | None = None,
                eps: float = 1e-12) -> torch.Tensor:
    """A full encoder layer on ``x`` (B, S, D), ``y = x + proj(MHA(LN1 x))``
    then ``y + fc2(gelu(fc1(LN2 y)))``, with the rounding of
    ``vit_tpu/ops/pallas/block.py:_layer_kernel`` (:1701-1720): the
    attention half rounds as :func:`attn_block` does up to the context, but
    its sum ``y = ctx @ wout + bout + x`` stays fp32. LN2 reads it
    unrounded (its output rounded to the dtype), the MLP accumulator starts
    at ``y + b2`` and the result is cast once. The pair :func:`attn_block`
    -> :func:`mlp_block` rounds ``y`` to the dtype in between."""
    xf, ctx = _attn_ctx(x, ln1_scale, ln1_bias, wqkv, bqkv,
                        num_heads=num_heads, scale=scale, seq_len=seq_len,
                        eps=eps)
    return layer_tail(ctx, xf, wout, bout, ln2_scale, ln2_bias, w1, b1, w2,
                      b2, eps=eps).reshape(x.shape)


def layer_tail(ctx: torch.Tensor, x: torch.Tensor, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2, *, eps: float = 1e-12) -> torch.Tensor:
    """The rest of :func:`layer_block` from the attention context ``ctx``
    (M, D) and the layer's input rows ``x`` (M, D): ``y = ctx @ wout + bout
    + x`` in fp32, then ``y + b2 + fc2(gelu(fc1(LN2 y)))`` with LN2 rounded
    to the dtype and one cast at the end. The plain version of K18
    (``csrc/layer_block.cu``)."""
    y32 = torch.matmul(_f32(ctx), _f32(wout)) + _f32(bout) + _f32(x)
    h = matmul(layernorm(y32, ln2_scale, ln2_bias, eps=eps).to(x.dtype), w1,
               b1, "gelu")
    return (y32 + _f32(b2) + torch.matmul(_f32(h), _f32(w2))).to(x.dtype)


def attn_block_partial(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv, wout,
                       *, num_heads: int, scale: float | None = None,
                       seq_len: int | None = None,
                       eps: float = 1e-12) -> torch.Tensor:
    """``proj_s(MHA_s(LN(x)))``, one tensor-parallel shard's attention half
    (``vit_tpu/ops/pallas/block.py:_attn_partial_kernel``): ``num_heads``
    is the shard's head count, ``wqkv`` (D, 3*dl) its head-major
    ``[q_s|k_s|v_s]`` columns, ``wout`` (dl, D) its rows. The rounding of
    :func:`attn_block`; the fp32 product is cast to ``x.dtype`` with no
    bias and no residual."""
    return _attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wout, None,
                      num_heads=num_heads, scale=scale, seq_len=seq_len,
                      eps=eps, residual=False)


def embed_fused(patches: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                cls_row: torch.Tensor, pos: torch.Tensor,
                sp: int) -> torch.Tensor:
    """Patch projection + CLS row + positions + zero pad to ``sp`` rows:
    ``(B, N, K) -> (B, sp, D)`` with the rounding of
    ``vit_tpu/ops/pallas/patch_embed.py:_embed_kernel``: ``z = patches @ w
    + bias`` in fp32, cast to the dtype, then ``[0 | z | 0] + [cls_row |
    pos | 0]`` in the dtype. ``cls_row`` (D,) already holds ``pos[0]``;
    ``pos`` is (N, D). The same numbers as the composed embed + pad."""
    b, n, _ = patches.shape
    d = w.shape[1]
    if sp < n + 1:
        raise ValueError(f"sp={sp} has no room for {n} patches and the CLS row")
    dt = patches.dtype
    z = matmul(patches, w, bias)
    base = torch.cat([cls_row.reshape(1, d).to(dt), pos.to(dt),
                      pos.new_zeros((sp - 1 - n, d), dtype=dt)])
    return torch.nn.functional.pad(z, (0, 0, 1, sp - 1 - n)) + base


def _layer_args(enc, i: int):
    """Layer ``i``'s (attn_block, mlp_block) weights from the stacked
    encoder params, as views."""
    attn = (enc["ln1"]["scale"][i], enc["ln1"]["bias"][i],
            enc["qkv"]["kernel"][i], enc["qkv"]["bias"][i],
            enc["out"]["kernel"][i], enc["out"]["bias"][i])
    mlp = (enc["ln2"]["scale"][i], enc["ln2"]["bias"][i],
           enc["fc1"]["kernel"][i], enc["fc1"]["bias"][i],
           enc["fc2"]["kernel"][i], enc["fc2"]["bias"][i])
    return attn, mlp


def encoder_stack(x: torch.Tensor, enc, *, num_heads: int,
                  scale: float | None = None, seq_len: int | None = None,
                  eps: float = 1e-12) -> torch.Tensor:
    """The whole stacked encoder on ``x`` (B, sp, D), after
    ``vit_tpu/ops/pallas/block.py:_encoder_stack_kernel``: each layer is
    :func:`attn_block` then :func:`mlp_block`, which already round where
    that kernel rounds (LN, q/k/v, p and the context in the dtype; the
    context divided by the fp32 row sum after PV; the MLP accumulator
    seeded with ``x + b2``)."""
    for i in range(enc["qkv"]["kernel"].shape[0]):
        attn, mlp = _layer_args(enc, i)
        x = attn_block(x, *attn, num_heads=num_heads, scale=scale,
                       seq_len=seq_len, eps=eps)
        x = mlp_block(x, *mlp, eps=eps)
    return x


def encoder_stack_fused(patches: torch.Tensor, enc, wemb: torch.Tensor,
                        base: torch.Tensor, lnf, *, num_heads: int, sp: int,
                        scale: float | None = None,
                        seq_len: int | None = None,
                        eps: float = 1e-12) -> torch.Tensor:
    """Patch embed + :func:`encoder_stack` + the final LN: ``patches``
    (B, N, K) -> (B, sp, D), pad rows included
    (``vit_tpu/ops/pallas/block.py:encoder_stack_fused``). ``base`` (sp, D)
    holds ``[cls + pos0 | pos + bias | 0]`` rounded to the dtype; ``lnf``
    is the final LN's ``{scale, bias}``. Two rounding points differ from
    the composed route, as in the kernel (``block.py:1909-1922, 1994-1998``):

    - (a) a patch row is ``patches @ wemb`` in fp32 plus ``base`` upcast,
      cast once (the composed route rounds ``z + bias`` first, then adds
      ``pos`` in the dtype);
    - (b) the last layer's MLP sum is not rounded: the final LN reads the
      fp32 accumulator and casts once.
    """
    b, n, _ = patches.shape
    d = wemb.shape[1]
    if sp < n + 1:
        raise ValueError(f"sp={sp} has no room for {n} patches and the CLS row")
    dt = patches.dtype
    rows = (torch.matmul(_f32(patches), _f32(wemb))
            + _f32(base[1:1 + n])).to(dt)
    x = torch.cat([base[:1].expand(b, 1, d), rows,
                   base[1 + n:].expand(b, sp - 1 - n, d)], dim=1)
    layers = enc["qkv"]["kernel"].shape[0]
    for i in range(layers):
        attn, mlp = _layer_args(enc, i)
        x = attn_block(x, *attn, num_heads=num_heads, scale=scale,
                       seq_len=seq_len, eps=eps)
        if i < layers - 1:
            x = mlp_block(x, *mlp, eps=eps)
    acc = _mlp_acc(x, *mlp, eps=eps)
    return layernorm(acc, lnf["scale"], lnf["bias"], eps=eps).to(dt)


# ------------------------------------------------------------------ int8 --
#
# The int8 tier's kernels with the Pallas kernels' rounding points. Integer
# products are exact: they run in float64, which holds every int8 x int8
# sum of up to 2^38 terms exactly (fc2 at H/14 reaches 5120 * 127^2, above
# fp32's 2^24), then round once to fp32, as ``acc.astype(f32)`` does.

QMAX = 127.0
#: Hidden columns per requantization group of ``mlp_block_i8dot``: the
#: ``ct`` of every ``mlpblocki8`` row of the JAX package's tuned table.
MLP_GROUP = 512


def div_qmax(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division on every device: PyTorch's CUDA
    kernels multiply by the reciprocal of a Python-scalar divisor, which
    rounds differently, so the divisor is a tensor."""
    return t / t.new_tensor(QMAX)


def _quantize_f32(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 of an fp32 ``(M, D)``, the Pallas kernels'
    order (``block.py:533-536``): ``ax = max(max|x|, 1e-12) / 127``, then
    ``round(x / ax)`` half to even, saturated at +-127 (a guard that never
    binds)."""
    ax = div_qmax(x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12))
    xq = torch.round(x32 / ax).clamp(-QMAX, QMAX).to(torch.int8)
    return xq, ax


def _ln32(x32: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LN of an fp32 row block, left in fp32 (``block.py:_ln32``)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * _f32(scale) + _f32(bias)


def quantize_rows(x: torch.Tensor, *, ln_scale: torch.Tensor | None = None,
                  ln_bias: torch.Tensor | None = None,
                  eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of ``x`` (..., D), optionally layer-normalised in fp32 first (not
    rounded to the dtype), quantized to int8: ``(xq (M, D) int8, ax (M, 1)
    fp32)`` with ``xq * ax ~ x``."""
    x32 = _f32(x).reshape(-1, x.shape[-1])
    if ln_scale is not None:
        x32 = _ln32(x32, ln_scale, ln_bias, eps)
    return _quantize_f32(x32)


def _int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int8 x int8 sums, rounded once to fp32."""
    return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(
        torch.float32)


def matmul_i8(xq: torch.Tensor, ax: torch.Tensor, wq: torch.Tensor,
              wscale: torch.Tensor, bias: torch.Tensor | None = None,
              activation: str | None = None, *,
              residual: torch.Tensor | None = None,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``xq (M, K) int8 @ wq (K, N) int8``, exact, then in fp32
    ``(acc * ax) * wscale``, ``+ bias``, GELU, ``+ residual``, one cast to
    ``out_dtype`` (``block.py:1229-1231, 1258, 1275-1276``)."""
    if xq.shape[-1] != wq.shape[0]:
        raise ValueError(f"matmul_i8 shapes {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)}")
    out = _int_product(xq, wq) * ax * wscale
    if bias is not None:
        out = out + _f32(bias)
    if activation == "gelu":
        out = gelu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    if residual is not None:
        out = out + _f32(residual).reshape(out.shape)
    return out.to(out_dtype)


def _attn_q_half(x: torch.Tensor, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                 wout_q, sout, bout, *, num_heads: int, scale: float | None,
                 seq_len: int | None, eps: float,
                 residual: bool) -> torch.Tensor:
    """Both int8 attention halves for ``x`` (B, S, D), dl from ``wqkv_q``,
    after ``vit_tpu/ops/pallas/block.py:_attn_q_kernel`` and
    ``_attn_q_partial_kernel``: LN in fp32, quantized per row; q/k/v
    rounded to the dtype; the per-head attention with ``p`` rounded to the
    dtype and the fp32 context left unrounded; the context quantized per
    row over its dl columns; the out-projection ``(acc * ac) * sout`` with
    ``+ bout`` and, with ``residual``, ``+ x`` in fp32 and one cast."""
    b, s, d = x.shape
    dl = wqkv_q.shape[1] // 3
    hd = dl // num_heads
    if scale is None:
        scale = hd ** -0.5
    xf = x.reshape(b * s, d)
    xq, ax = quantize_rows(xf, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps)
    qkv = matmul_i8(xq, ax, wqkv_q, sqkv, bqkv, out_dtype=x.dtype)
    q, k, v = qkv.view(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    ctx = attention(q, k, v, scale=scale, seq_len=seq_len,
                    out_dtype=torch.float32)
    cq, ac = quantize_rows(ctx.permute(0, 2, 1, 3).reshape(b * s, dl))
    return matmul_i8(cq, ac, wout_q, sout, bout,
                     residual=xf if residual else None,
                     out_dtype=x.dtype).reshape(b, s, d)


def attn_block_q(x: torch.Tensor, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                 wout_q, sout, bout, *, num_heads: int,
                 scale: float | None = None, seq_len: int | None = None,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x + proj(MHA(LN(x)))`` with int8 projections, rounded as
    :func:`_attn_q_half` says (the context quantized over all heads)."""
    return _attn_q_half(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q,
                        sout, bout, num_heads=num_heads, scale=scale,
                        seq_len=seq_len, eps=eps, residual=True)


def attn_block_q_partial(x: torch.Tensor, ln_scale, ln_bias, wqkv_q, sqkv,
                         bqkv, wout_q, sout, *, num_heads: int,
                         scale: float | None = None,
                         seq_len: int | None = None,
                         eps: float = 1e-12) -> torch.Tensor:
    """One tensor-parallel shard's int8 attention half: the rounding of
    :func:`attn_block_q` on the shard's heads, the context rows quantized
    over the shard's ``dl`` columns, the out-projection cast to
    ``x.dtype`` with no bias and no residual."""
    return _attn_q_half(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wout_q,
                        sout, None, num_heads=num_heads, scale=scale,
                        seq_len=seq_len, eps=eps, residual=False)


def mlp_block_i8dot(x: torch.Tensor, ln_scale, ln_bias, w1q, s1, b1, w2q, s2,
                    b2, *, eps: float = 1e-12, group: int = MLP_GROUP,
                    partial_out: bool = False) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` with both products in int8, after
    ``vit_tpu/ops/pallas/block.py:_mlp_i8dot_kernel``: LN in fp32 quantized
    per row; the fp32 sum seeded with ``x + b2`` (with zero for
    ``partial_out``, ``b2`` ignored); for each ``group`` hidden columns ``h
    = gelu((acc1 * ax) * s1 + b1)``, quantized per row over the group, and
    ``acc += (acc2 * ah) * s2``; one cast."""
    d = x.shape[-1]
    mlp = w1q.shape[1]
    if mlp % group:
        raise ValueError(f"mlp {mlp} is not a multiple of the quant group "
                         f"{group}")
    xf = x.reshape(-1, d)
    xq, ax = quantize_rows(xf, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps)
    acc = torch.zeros_like(_f32(xf)) if partial_out else _f32(xf) + _f32(b2)
    for c0 in range(0, mlp, group):
        cols = slice(c0, c0 + group)
        h = _int_product(xq, w1q[:, cols]) * ax * s1[cols]
        hq, ah = _quantize_f32(gelu(h + _f32(b1[cols])))
        acc = acc + _int_product(hq, w2q[cols]) * ah * s2
    return acc.to(x.dtype).reshape(x.shape)


def mlp_block_q(x: torch.Tensor, ln_scale, ln_bias, w1q, s1, b1, w2q, s2,
                b2, *, eps: float = 1e-12,
                partial_out: bool = False) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` on weight-only int8 weights, after
    ``vit_tpu/ops/pallas/block.py:_mlp_q_kernel``: LN in fp32, rounded to
    the dtype; for each :data:`MLP_GROUP` hidden columns ``h = gelu((xn @
    w1) * s1 + b1)`` in fp32, rounded to the dtype, and ``acc += (h @ w2) *
    s2`` on an fp32 accumulator seeded with ``x + b2``; one cast. The
    activations are never quantized. JAX scales fc2 per chunk of its
    plan's ``ct``; the port's chunk is fixed (its kernel's), which changes
    only the fp32 sum order. ``partial_out`` as in :func:`mlp_block_i8dot`."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    xn = layernorm(xf, ln_scale, ln_bias, eps=eps)
    acc = torch.zeros_like(_f32(xf)) if partial_out else _f32(xf) + _f32(b2)
    for c0 in range(0, w1q.shape[1], MLP_GROUP):
        cols = slice(c0, c0 + MLP_GROUP)
        h = matmul(xn, w1q[:, cols], b1[cols], "gelu", wscale=s1[cols])
        acc = acc + torch.matmul(_f32(h), _f32(w2q[cols])) * s2
    return acc.to(x.dtype).reshape(x.shape)


def encoder_stack_q(x: torch.Tensor, enc, *, num_heads: int,
                    scale: float | None = None, seq_len: int | None = None,
                    eps: float = 1e-12) -> torch.Tensor:
    """The whole encoder on weight-only int8 ``enc`` (each projection's
    ``kernel`` is ``{"q", "scale"}``), after
    ``vit_tpu/ops/pallas/block.py:_encoder_stack_q_kernel``: the float
    stack's rounding points (LN, q/k/v, the context and the GELU hidden in
    the dtype), each product scaled per column before its bias. The fc2 sum
    is scaled once over the whole K, where JAX scales each ``mt`` chunk:
    only the fp32 sum order differs."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    for i in range(enc["qkv"]["kernel"]["q"].shape[0]):
        def w(name):
            k = enc[name]["kernel"]
            return k["q"][i], enc[name]["bias"][i], k["scale"][i]

        wq, bq, sq = w("qkv")
        qkv = matmul(layernorm(xf, enc["ln1"]["scale"][i],
                               enc["ln1"]["bias"][i], eps=eps),
                     wq, bq, wscale=sq)
        ctx = attention_core(qkv, batch=b, num_heads=num_heads,
                             scale=(d // num_heads) ** -0.5
                             if scale is None else scale,
                             seq_len=s if seq_len is None else seq_len)
        wo, bo, so = w("out")
        xf = matmul(ctx, wo, bo, residual=xf, wscale=so)
        w1, b1, s1 = w("fc1")
        h = matmul(layernorm(xf, enc["ln2"]["scale"][i],
                             enc["ln2"]["bias"][i], eps=eps),
                   w1, b1, "gelu", wscale=s1)
        w2, b2, s2 = w("fc2")
        acc = _f32(xf) + _f32(b2)
        xf = (acc + torch.matmul(_f32(h), _f32(w2)) * s2).to(x.dtype)
    return xf.reshape(b, s, d)
