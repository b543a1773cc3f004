"""Int8 serving tier (counterpart of ``vit_tpu/quant.py``).

Weight-and-activation symmetric int8 for every encoder projection (QKV,
attention out-projection, fc1, fc2): weights are quantized offline per
output channel, activations per row as they run, and the products are
s8 x s8 -> s32 on the card's int8 tensor cores. LayerNorm, softmax, GELU,
residuals, the attention score and context products, the patch embedding
and the head stay in float.

:func:`forward_quant` routes as ``vit_tpu/quant.py:forward_quant(impl=
"pallas")`` does: the embedding through the float tier's ``embed`` (so
``embed_fused`` at batch <= 4), then the whole encoder as one
``encoder_stack_q`` where ``ops.stack_q_plan`` says so (weight-only int8,
activations in float), else ``attn_block_q`` then ``mlp_block_i8dot`` (or,
with ``int8_dot=False``, the weight-only ``mlp_block_q``) for each layer;
then the final LN, the slice and the tail. With CUDA tensors
each op runs its hand-written kernel, with CPU tensors (or
``impl="torch"``) its plain version.

No speed is claimed here: the int8 figures in the JAX package were taken
on a TPU v5e and say nothing about the H100.
"""

from __future__ import annotations

import functools

import torch

from vit_tpu_torch import ops
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models.vit import (Params, _forward_tail, _padded_seq,
                                      embed, forward_with_intermediates)
from vit_tpu_torch.ops import reference as ref
from vit_tpu_torch.weights.convert import tree_map

#: The projections ``quantize_params`` quantizes.
QUANTIZED = ("qkv", "out", "fc1", "fc2")


def quantize_weight(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8: ``w (..., K, N)`` -> ``{"q": int8
    of w's shape, "scale": fp32 (..., N)}`` with ``q * scale ~ w``; the
    same bits as ``vit_tpu/quant.py:quantize_weight`` (``torch.round``
    rounds half to even, as ``jnp.round`` does)."""
    w32 = w.to(torch.float32)
    scale = ref.div_qmax(w32.abs().amax(dim=-2)).clamp_min(1e-12)
    q = torch.round(w32 / scale.unsqueeze(-2))
    return {"q": q.clamp(-ref.QMAX, ref.QMAX).to(torch.int8),
            "scale": scale}


def quantize_params(params: Params) -> Params:
    """``params`` with each of ``encoder.{qkv,out,fc1,fc2}.kernel`` replaced
    by :func:`quantize_weight` of it (layer axis kept); everything else is
    passed through."""
    enc = dict(params["encoder"])
    for name in QUANTIZED:
        enc[name] = {"kernel": quantize_weight(enc[name]["kernel"]),
                     "bias": enc[name]["bias"]}
    return {**params, "encoder": enc}


def int8_matmul(x: torch.Tensor, wq: dict[str, torch.Tensor],
                bias: torch.Tensor | None = None,
                activation: str | None = None, *,
                impl: str | None = None) -> torch.Tensor:
    """``(..., M, K) @ int8 (K, N)`` with per-row activation quant, the XLA
    tier's function (``vit_tpu/quant.py:int8_matmul``). Its scale is
    ``max|x| / 127`` floored at 1e-12, in that order (the kernels floor the
    max first, then divide). The product runs on ``ops.matmul_i8``."""
    x32 = x.to(torch.float32).reshape(-1, x.shape[-1])
    ax = ref.div_qmax(x32.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-12)
    xq = torch.round(x32 / ax).to(torch.int8)
    y = ops.matmul_i8(xq, ax, wq["q"], wq["scale"], bias, activation,
                      out_dtype=x.dtype, impl=impl)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def smooth_params(params: Params, cfg: ViTConfig, pixels: torch.Tensor,
                  alpha: float = 0.5) -> Params:
    """SmoothQuant-style outlier migration into the QKV and fc1 weights
    (``vit_tpu/quant.py:smooth_params``): per input channel j,
    ``c_j = amax_act_j**alpha / amax_w_j**(1 - alpha)``, calibrated on
    ``pixels`` through the float model, then ``LN_scale /= c``,
    ``LN_bias /= c`` and ``W[j, :] *= c_j``. Exactly the float model; the
    rows the int8 tier quantizes become flatter."""
    _, hiddens = forward_with_intermediates(params, pixels, cfg,
                                            impl="torch")
    enc = {k: dict(v) for k, v in params["encoder"].items()}
    f32 = torch.float32

    def fold(ln_name, w_name, act_amax):
        ln, w = dict(enc[ln_name]), dict(enc[w_name])
        w_amax = w["kernel"].to(f32).abs().amax(dim=-1)
        c = (act_amax.clamp_min(1e-6) ** alpha
             / w_amax.clamp_min(1e-6) ** (1 - alpha)).clamp_min(1e-6)
        dt = ln["scale"].dtype
        ln["scale"] = (ln["scale"].to(f32) / c).to(dt)
        ln["bias"] = (ln["bias"].to(f32) / c).to(dt)
        w["kernel"] = (w["kernel"].to(f32) * c[..., None]).to(
            w["kernel"].dtype)
        enc[ln_name], enc[w_name] = ln, w

    # Per-layer amax of each LN's output: ln1 sees the block input, ln2 the
    # activation after the float attention half, recomputed here.
    eps, nh, hd = cfg.layernorm_eps, cfg.num_heads, cfg.head_dim
    ln1_amax, ln2_amax = [], []
    for l in range(cfg.num_layers):
        lp = tree_map(lambda a: a[l], params["encoder"])
        x = hiddens[l]
        xn = ref.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps=eps)
        ln1_amax.append(xn.to(f32).abs().amax(dim=(0, 1)))
        b, s, d = x.shape
        qkv = ref.matmul(xn, lp["qkv"]["kernel"], lp["qkv"]["bias"])
        q, k, v = qkv.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q.to(f32) @ k.to(f32).transpose(-1, -2)
                          * hd ** -0.5, dim=-1)
        ctx = (a @ v.to(f32)).to(x.dtype).permute(0, 2, 1, 3).reshape(b, s, d)
        xa = x + ref.matmul(ctx, lp["out"]["kernel"], lp["out"]["bias"])
        xn2 = ref.layernorm(xa, lp["ln2"]["scale"], lp["ln2"]["bias"],
                            eps=eps)
        ln2_amax.append(xn2.to(f32).abs().amax(dim=(0, 1)))

    fold("ln1", "qkv", torch.stack(ln1_amax))
    fold("ln2", "fc1", torch.stack(ln2_amax))
    return {**params, "encoder": enc}


def forward_quant(qparams: Params, pixels: torch.Tensor, cfg: ViTConfig, *,
                  impl: str | None = None,
                  int8_dot: bool = True) -> torch.Tensor:
    """ViT forward on :func:`quantize_params` weights, with the contract of
    ``vit_tpu_torch.models.vit.forward`` (hidden states, pooled embedding
    or logits per ``cfg``); the route is the module docstring's.

    ``int8_dot=False`` is JAX's ``VIT_TPU_INT8_DOT=0``: the per-layer
    route's MLP half runs the weight-only ``mlp_block_q`` (activations in
    float) in place of ``mlp_block_i8dot``; the stack route is weight-only
    already and does not change.

    The hidden's quant group of ``mlp_block_i8dot`` (and the chunk of
    ``mlp_block_q``) is fixed at 512 columns, so the geometry must be one
    that ``ops.mlp_q_plan`` takes: ``cfg.mlp_dim`` a multiple of 512 and D
    a multiple of 128 up to 1280 (every ``VARIANTS`` entry). The head runs
    on the float ``matmul`` kernel and rounds once, where JAX's ``pooled @
    kernel + bias`` rounds the product to the dtype before adding the
    bias."""
    if not ops.mlp_q_plan(cfg.hidden_dim, cfg.mlp_dim):
        raise ValueError(f"the int8 MLP kernels take D a multiple of 128 up "
                         f"to 1280 and mlp_dim a multiple of their quant "
                         f"group {ref.MLP_GROUP}; got D={cfg.hidden_dim}, "
                         f"mlp_dim={cfg.mlp_dim}")
    s, sp = cfg.seq_len, _padded_seq(cfg)
    x = embed(qparams, pixels, cfg, impl=impl, sp=sp)
    b, d, nh = x.shape[0], cfg.hidden_dim, cfg.num_heads
    enc = qparams["encoder"]
    kw = dict(num_heads=nh, scale=cfg.head_dim ** -0.5, seq_len=s,
              eps=cfg.layernorm_eps, impl=impl)
    if ops.stack_q_plan(b, sp, d, cfg.mlp_dim, nh, cfg.dtype):
        x = ops.encoder_stack_q(x, enc, **kw)
    else:
        mlp_half = ops.mlp_block_i8dot if int8_dot else ops.mlp_block_q
        for i in range(cfg.num_layers):
            lp = tree_map(lambda t: t[i], enc)
            kq, ko = lp["qkv"]["kernel"], lp["out"]["kernel"]
            x = ops.attn_block_q(
                x, lp["ln1"]["scale"], lp["ln1"]["bias"], kq["q"],
                kq["scale"], lp["qkv"]["bias"], ko["q"], ko["scale"],
                lp["out"]["bias"], **kw)
            k1, k2 = lp["fc1"]["kernel"], lp["fc2"]["kernel"]
            x = mlp_half(
                x, lp["ln2"]["scale"], lp["ln2"]["bias"], k1["q"],
                k1["scale"], lp["fc1"]["bias"], k2["q"], k2["scale"],
                lp["fc2"]["bias"], eps=cfg.layernorm_eps, impl=impl)
    x = ops.layernorm(x, qparams["ln_final"]["scale"],
                      qparams["ln_final"]["bias"], eps=cfg.layernorm_eps,
                      impl=impl)
    return _forward_tail(x, qparams, cfg, s, sp, impl)


def make_forward_quant(cfg: ViTConfig, *, impl: str | None = None,
                       int8_dot: bool = True):
    """:func:`forward_quant` with the config, implementation and MLP kernel
    bound."""
    return functools.partial(forward_quant, cfg=cfg, impl=impl,
                             int8_dot=int8_dot)
