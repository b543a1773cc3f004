"""Differentiable ops of the kernel tier (counterpart of
``vit_tpu/ops/pallas/vjp.py``): one ``torch.autograd.Function`` per op.

Each Function runs its kernel in ``forward`` and, in ``backward``, the
composition of JAX's custom VJP for that op:

- the products run on the forward kernels: every ``dx``, ``dw`` and
  rematerialised pre-activation on K2 (``matmul``), which takes the
  transposes ``x.t()`` and ``w.t()`` as views (its bf16 ``wgmma`` tile
  reads them in place; for its other tiles the wrapper copies them, as
  XLA copies them before an opaque ``pallas_call``);
- the elementwise and reduction glue (GELU, layernorm and softmax
  backward, bias and embedding row sums) is torch ops in fp32, as JAX's
  is jnp; ``matmul3``'s two products run on K16, as JAX's run its kernel;
- the attention backward is its own kernel, K13 ``flash_attention_bwd``,
  at every sequence length: its shared memory does not grow with S, so
  JAX's switch to a jnp chain above 768 padded tokens (``vjp.py:378-385``),
  a VMEM limit of the TPU, has no counterpart here;
- the mega-kernels (``mlp_block``, ``attn_block``, ``layer_block``, both
  ``encoder_stack`` forms) save only their inputs and recompute through
  the composed differentiable chain (``_mlp_composed``, ``_attn_composed``,
  the per-layer loop), whose forward runs K5 + K6, K7 and K2 again.

Every kernel slot is filled by :func:`~vit_tpu_torch.ops.dispatch.kernel_fn`:
the CUDA wrapper for a CUDA tensor, the plain version for a CPU tensor, so
the CPU tests walk the backward composition that the card runs. The int8
ops are not differentiable, as in JAX.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import kernel_fn

#: The stacked encoder leaves, in the order the stack Functions take them.
ENC_LEAVES = (("ln1", "scale"), ("ln1", "bias"), ("qkv", "kernel"),
              ("qkv", "bias"), ("out", "kernel"), ("out", "bias"),
              ("ln2", "scale"), ("ln2", "bias"), ("fc1", "kernel"),
              ("fc1", "bias"), ("fc2", "kernel"), ("fc2", "bias"))


class _NoCtx:
    """Stands in for a Function's ``ctx`` where nothing is recorded."""

    def save_for_backward(self, *tensors) -> None:
        pass


def run(fn: type[torch.autograd.Function], *args):
    """``fn.apply(*args)`` where grad mode is on; otherwise only ``fn``'s
    forward, the kernel call, without the Function's bookkeeping (the
    serving path runs under ``torch.inference_mode``)."""
    if torch.is_grad_enabled():
        return fn.apply(*args)
    return fn.forward(_NoCtx(), *args)


def _c(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _mm(impl, x, w, bias=None, activation=None):
    """K2 on its operands as they come: a transpose goes as the view it
    is, and the wrapper reads it in place or copies it, by tile."""
    return kernel_fn("matmul", impl, x)(x, w, bias, activation)


def _row_sum(gf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The fp32 sum over rows, cast to ``like``'s dtype (a bias grad)."""
    return gf.float().sum(dim=0).to(like.dtype)


def _gelu_back(gf: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    return (gf.float() * reference.gelu_grad(pre.float())).to(gf.dtype)


def _remat(fn, inputs, needs, g):
    """The gradients of ``fn(*inputs)`` for the output gradient ``g``,
    recomputed under autograd (JAX's ``jax.vjp`` of the composed chain);
    None where ``needs`` is False."""
    if not any(needs):
        return (None,) * len(inputs)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = fn(*leaves)
        wrt = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


# ----------------------------------------------------------------- linear --

class Linear(torch.autograd.Function):
    """``act(x @ w + b) + residual`` on K2 (``vjp.py:linear``; the residual
    is the port's K2 extension, its gradient ``g``)."""

    @staticmethod
    def forward(ctx, x, w, b, residual, activation, impl):
        ctx.save_for_backward(x, w, b)
        ctx.activation, ctx.impl = activation, impl
        ctx.has_res = residual is not None
        return kernel_fn("matmul", impl, x)(x, w, b, activation, residual)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        need, impl = ctx.needs_input_grad, ctx.impl
        k, n = w.shape
        gf = _c(g.reshape(-1, n))
        if ctx.activation == "gelu":
            gf = _gelu_back(gf, _mm(impl, x.reshape(-1, k), w, b))
        dx = _mm(impl, gf, w.t()).reshape(x.shape) if need[0] else None
        dw = _mm(impl, x.reshape(-1, k).t(), gf) if need[1] else None
        db = _row_sum(gf, b) if b is not None and need[2] else None
        dres = g if ctx.has_res and need[3] else None
        return dx, dw, db, dres, None, None


class FusedLinear(torch.autograd.Function):
    """``act(LN(x) @ w + b) + residual``: K5 then K6 with LN, K2 without
    (``vjp.py:fused_linear``). The backward recomputes ``h = LN(x)`` in
    torch ops and the pre-activation on K2."""

    @staticmethod
    def forward(ctx, x, w, b, ln_scale, ln_bias, residual, activation, eps,
                impl):
        ctx.save_for_backward(x, w, b, ln_scale, ln_bias)
        ctx.activation, ctx.eps, ctx.impl = activation, eps, impl
        ctx.has_res = residual is not None
        return kernel_fn("fused_linear", impl, x)(
            x, w, b, activation, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
            residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, w, b, gam, bet = ctx.saved_tensors
        need, impl, eps = ctx.needs_input_grad, ctx.impl, ctx.eps
        k, n = w.shape
        xf = x.reshape(-1, k)
        gf = _c(g.reshape(-1, n))
        h = xf if gam is None else reference.layernorm(xf, gam, bet, eps=eps)
        if ctx.activation == "gelu":
            gf = _gelu_back(gf, _mm(impl, h, w, b))
        db = _row_sum(gf, b) if b is not None and need[2] else None
        dw = _mm(impl, h.t(), gf) if need[1] else None
        dx = dgam = dbet = None
        if need[0] or need[3] or need[4]:
            dh = _mm(impl, gf, w.t())
            if gam is None:
                dx = dh.to(x.dtype)
            else:
                dx, dgam, dbet = reference.layernorm_grad(xf, gam, dh, eps=eps)
                dgam, dbet = dgam.to(gam.dtype), dbet.to(bet.dtype)
            dx = dx.reshape(x.shape)
        dres = g if ctx.has_res and need[5] else None
        return dx, dw, db, dgam, dbet, dres, None, None, None


class LayerNorm(torch.autograd.Function):
    """Row layernorm on K1; the backward in fp32 torch ops
    (``vjp.py:layernorm``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, impl):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return kernel_fn("layernorm", impl, x)(x, scale, bias, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = reference.layernorm_grad(x, scale, g, eps=ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None, None


# ----------------------------------------------- the reference op chain --

class Matmul3(torch.autograd.Function):
    """``(x @ y) * scale`` over a batch on K16 (``vjp.py:matmul3``); the
    backward is two K16 launches, ``dx = (g @ yᵀ) * scale`` and ``dy =
    (xᵀ @ g) * scale``, the transposes copied contiguous first."""

    @staticmethod
    def forward(ctx, x, y, scale, impl):
        ctx.save_for_backward(x, y)
        ctx.scale, ctx.impl = scale, impl
        return kernel_fn("matmul3", impl, x)(x, y, scale=scale)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        mm3 = kernel_fn("matmul3", ctx.impl, x)
        g = _c(g)
        dx = mm3(g, _c(y.transpose(1, 2)), scale=ctx.scale) if need[0] else None
        dy = mm3(_c(x.transpose(1, 2)), g, scale=ctx.scale) if need[1] else None
        return dx, dy, None, None


class Softmax(torch.autograd.Function):
    """Row softmax on K15 (``vjp.py:softmax``); the backward ``p (g -
    Σ g p)`` in fp32 torch ops, cast, as JAX's is jnp."""

    @staticmethod
    def forward(ctx, x, impl):
        p = kernel_fn("softmax", impl, x)(x)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        g32, p32 = g.float(), p.float()
        dx = p32 * (g32 - (g32 * p32).sum(dim=-1, keepdim=True))
        return dx.to(p.dtype), None


class Add(torch.autograd.Function):
    """``x + y`` on K14 (``vjp.py:add``); the backward is ``(g, g)``."""

    @staticmethod
    def forward(ctx, x, y, impl):
        return kernel_fn("add", impl, x)(x, y)

    @staticmethod
    def backward(ctx, g):
        return g, g, None


# -------------------------------------------------------------- attention --

class Attention(torch.autograd.Function):
    """Masked softmax attention over the heads of a packed
    ``(B, S, 3, H, d)`` QKV buffer (``vjp.py:attention``): K7 on strided
    ``(B, H, S, d)`` views forward, K13 backward. K13 writes the packed
    gradient ``[dq | dk | dv]``, so it is the buffer's gradient as it
    stands: the QKV ``FusedLinear`` takes it with no concatenation."""

    @staticmethod
    def forward(ctx, qkv, scale, seq_len, impl):
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.seq_len, ctx.impl = scale, seq_len, impl
        q, k, v = reference.split_qkv(qkv)
        return kernel_fn("flash_attention", impl, q)(q, k, v, scale=scale,
                                                     seq_len=seq_len)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        q, k, v = reference.split_qkv(qkv)
        g = g if g.stride(-1) == 1 else g.contiguous()
        dqkv = kernel_fn("flash_attention_bwd", ctx.impl, q)(
            q, k, v, g, scale=ctx.scale, seq_len=ctx.seq_len)
        return dqkv, None, None, None


# -------------------------------------------------- mega-kernels (remat) --

def _mlp_composed(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, impl):
    """``vjp.py:_mlp_composed``: FusedLinear (LN, GELU) then FusedLinear
    (+ x)."""
    h = FusedLinear.apply(x, w1, b1, ln_scale, ln_bias, None, "gelu", eps,
                          impl)
    return FusedLinear.apply(h, w2, b2, None, None, x, None, eps, impl)


def _attn_composed(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, num_heads,
                   scale, seq_len, eps, impl):
    """``vjp.py:_attn_composed``: FusedLinear (LN) -> attention ->
    FusedLinear (+ x), on ``x`` (B, S, D)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    qkv = FusedLinear.apply(xf, wqkv, bqkv, ln_scale, ln_bias, None, None,
                            eps, impl)
    ctx = Attention.apply(qkv.view(b, s, 3, num_heads, d // num_heads),
                          scale, seq_len, impl)
    ctx = _c(ctx.transpose(1, 2).reshape(b * s, d))
    return FusedLinear.apply(ctx, wout, bout, None, None, xf, None, eps,
                             impl).view(b, s, d)


def _stack_composed(x, flat, num_heads, scale, seq_len, eps, impl):
    """``vjp.py:_stack_composed``: the composed layers over the stacked
    leaves, each unbound once so that the backward stacks each leaf's
    per-layer gradients once."""
    per = [t.unbind(0) for t in flat]
    for i in range(len(per[0])):
        lp = [p[i] for p in per]
        x = _attn_composed(x, *lp[:6], num_heads, scale, seq_len, eps, impl)
        x = _mlp_composed(x, *lp[6:], eps, impl)
    return x


def _stack_fused_composed(patches, wemb, base, lnf_scale, lnf_bias, flat,
                          num_heads, sp, scale, seq_len, eps, impl):
    """``vjp.py:_stack_fused_composed``: the embedding assembled in fp32
    torch ops (``patches @ wemb + base``, one cast), the composed layers,
    the final LN in torch ops."""
    b, n, _ = patches.shape
    d = wemb.shape[1]
    z = torch.matmul(patches.float(), wemb.float())
    base32 = base.float()
    x = torch.cat([base32[:1].expand(b, 1, d), z + base32[1:1 + n],
                   base32[1 + n:].expand(b, sp - 1 - n, d)], dim=1)
    x = _stack_composed(x.to(patches.dtype), flat, num_heads, scale, seq_len,
                        eps, impl)
    return reference.layernorm(x, lnf_scale, lnf_bias, eps=eps)


class MlpBlock(torch.autograd.Function):
    """``x + fc2(gelu(fc1(LN(x))))`` on K3 (``vjp.py:mlp_block``)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, impl):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.eps, ctx.impl = eps, impl
        return kernel_fn("mlp_block", impl, x)(x, ln_scale, ln_bias, w1, b1,
                                               w2, b2, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = _remat(lambda *a: _mlp_composed(*a, ctx.eps, ctx.impl),
                       ctx.saved_tensors, ctx.needs_input_grad[:7], g)
        return (*grads, None, None)


class AttnBlock(torch.autograd.Function):
    """``x + proj(MHA(LN(x)))`` on K4's four launches
    (``vjp.py:attn_block``)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, num_heads,
                scale, seq_len, eps, impl):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout)
        ctx.args = (num_heads, scale, seq_len, eps, impl)
        return kernel_fn("attn_block", impl, x)(
            x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
            num_heads=num_heads, scale=scale, seq_len=seq_len, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = _remat(lambda *a: _attn_composed(*a, *ctx.args),
                       ctx.saved_tensors, ctx.needs_input_grad[:7], g)
        return (*grads, None, None, None, None, None)


class LayerBlock(torch.autograd.Function):
    """A full encoder layer on K1, K2, the attention core and K18
    (``vjp.py:layer_block``); the backward recomputes through
    ``_attn_composed`` then ``_mlp_composed`` (``vjp.py:609-643``), the
    per-layer route's backward."""

    @staticmethod
    def forward(ctx, x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads, scale, seq_len,
                eps, impl):
        ctx.save_for_backward(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                              ln2_scale, ln2_bias, w1, b1, w2, b2)
        ctx.args = (num_heads, scale, seq_len, eps, impl)
        return kernel_fn("layer_block", impl, x)(
            x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
            ln2_bias, w1, b1, w2, b2, num_heads=num_heads, scale=scale,
            seq_len=seq_len, eps=eps)

    @staticmethod
    def backward(ctx, g):
        num_heads, scale, seq_len, eps, impl = ctx.args

        def chain(x, *p):
            y = _attn_composed(x, *p[:6], num_heads, scale, seq_len, eps,
                               impl)
            return _mlp_composed(y, *p[6:], eps, impl)
        grads = _remat(chain, ctx.saved_tensors, ctx.needs_input_grad[:13], g)
        return (*grads, None, None, None, None, None)


def _enc_tree(flat):
    tree: dict = {}
    for (name, key), t in zip(ENC_LEAVES, flat):
        tree.setdefault(name, {})[key] = t
    return tree


def enc_leaves(enc) -> list:
    """The stacked encoder tensors in :data:`ENC_LEAVES` order."""
    return [enc[name][key] for name, key in ENC_LEAVES]


class EncoderStack(torch.autograd.Function):
    """The whole encoder on K9 (``vjp.py:encoder_stack``); the backward
    recomputes through the per-layer composed chain. Takes the twelve
    stacked leaves last, in :data:`ENC_LEAVES` order."""

    @staticmethod
    def forward(ctx, x, num_heads, scale, seq_len, eps, impl, *flat):
        ctx.save_for_backward(x, *flat)
        ctx.args = (num_heads, scale, seq_len, eps, impl)
        return kernel_fn("encoder_stack", impl, x)(
            x, _enc_tree(flat), num_heads=num_heads, scale=scale,
            seq_len=seq_len, eps=eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        grads = _remat(lambda x, *flat: _stack_composed(x, flat, *ctx.args),
                       ctx.saved_tensors, (need[0], *need[6:]), g)
        return (grads[0], None, None, None, None, None, *grads[1:])


class EncoderStackFused(torch.autograd.Function):
    """Patch embed, the whole encoder and the final LN on K9's fold
    (``vjp.py:encoder_stack_fused``); the backward recomputes through the
    embedding assembly, the per-layer composed chain and the final LN."""

    @staticmethod
    def forward(ctx, patches, wemb, base, lnf_scale, lnf_bias, num_heads, sp,
                scale, seq_len, eps, impl, *flat):
        ctx.save_for_backward(patches, wemb, base, lnf_scale, lnf_bias, *flat)
        ctx.args = (num_heads, sp, scale, seq_len, eps, impl)
        return kernel_fn("encoder_stack_fused", impl, patches)(
            patches, _enc_tree(flat), wemb, base,
            {"scale": lnf_scale, "bias": lnf_bias}, num_heads=num_heads,
            sp=sp, scale=scale, seq_len=seq_len, eps=eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad

        def chain(patches, wemb, base, lnf_scale, lnf_bias, *flat):
            return _stack_fused_composed(patches, wemb, base, lnf_scale,
                                         lnf_bias, flat, *ctx.args)
        grads = _remat(chain, ctx.saved_tensors, (*need[:5], *need[11:]), g)
        return (*grads[:5], None, None, None, None, None, None, *grads[5:])


class EmbedFused(torch.autograd.Function):
    """Patch projection + CLS row + positions + zero pad on K8
    (``vit_tpu/ops/pallas/patch_embed.py:embed_fused``, which JAX
    differentiates through the kernel's body). The backward is that of the
    composed embedding: the projection's ``dw`` (and the patches' gradient,
    where needed) on K2, ``db``, ``d cls_row`` and ``d pos`` as fp32 row
    sums."""

    @staticmethod
    def forward(ctx, patches, w, bias, cls_row, pos, sp, impl):
        ctx.save_for_backward(patches, w, bias)
        ctx.impl = impl
        return kernel_fn("embed_fused", impl, patches)(patches, w, bias,
                                                       cls_row, pos, sp)

    @staticmethod
    def backward(ctx, g):
        patches, w, bias = ctx.saved_tensors
        need, impl = ctx.needs_input_grad, ctx.impl
        b, n, k = patches.shape
        d = w.shape[1]
        dz = _c(g[:, 1:1 + n].reshape(b * n, d))
        dpatches = (_mm(impl, dz, w.t()).reshape(b, n, k) if need[0]
                    else None)
        dw = _mm(impl, patches.reshape(b * n, k).t(), dz) if need[1] else None
        db = _row_sum(dz, bias) if need[2] else None
        dcls = _row_sum(g[:, 0], bias) if need[3] else None
        dpos = (g[:, 1:1 + n].float().sum(dim=0).to(bias.dtype) if need[4]
                else None)
        return dpatches, dw, db, dcls, dpos, None, None
