"""ViT forward graph (counterpart of ``vit_tpu/models/vit.py``).

Plain functions on a params dict, plus a thin :class:`ViT` module. The
layout is the JAX package's: linear weights ``(in, out)``, encoder tensors
stacked along a leading ``num_layers`` axis (layer l's weights are the
contiguous view ``w[l]``, so no per-layer copy is made), fused ``(D, 3D)``
QKV.

:func:`forward` routes as ``vit_tpu/models/vit.py:forward`` does, by
``attention="flash" | "unfused"`` and ``fused`` (:func:`encoder_block`
says what each runs) and, on the default ``("flash", True)``, by batch
size. The flash route runs the encoder at a token count padded to a
multiple of 16 (197 -> 208 for B/16, 577 -> 592 for L/16-384), the unfused
route at the real count; the pad is sliced off after the final
``layernorm``, then the tail pools or classifies. The default route, by
batch size:

- ``ops.stack_fused_plan`` (bf16 B/16-class widths at batch <= 2, L/16 at
  batch 1): patch embed, the whole encoder and the final LN are one
  ``encoder_stack_fused`` kernel;
- otherwise the embedding is ``embed_fused`` where ``ops.embed_fused_ok``
  (one prefix token, batch <= 4), else composed and zero-padded; then the
  encoder is one ``encoder_stack`` kernel where ``ops.stack_plan`` (DeiT-B/16
  bf16 at batch <= 2), else one :func:`encoder_block` a layer, the
  throughput route (with ``layer_block=True``, one full-layer
  ``layer_block`` a layer where ``ops.layer_plan`` takes the geometry);
  then the final ``layernorm``.

Padded keys are masked inside attention and every other op is row-wise, so
the pad rows never touch the real ones. With CUDA tensors each op runs its
hand-written kernel; with CPU tensors (or ``impl="torch"``) its plain
PyTorch version. The plans read geometry and dtype only, so both take the
same route.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.weights.convert import Params, to_device


def init_params(cfg: ViTConfig, *, generator: torch.Generator,
                device: torch.device | str = "cuda") -> Params:
    """Random params (HF-style truncated normal, std 0.02, cut at 2 std),
    drawn in fp32 on ``generator``'s device, returned in ``cfg.dtype`` on
    ``device``. Encoder tensors are stacked along ``num_layers``."""
    d, l, m = cfg.hidden_dim, cfg.num_layers, cfg.mlp_dim
    gen_dev = generator.device
    dt = cfg.dtype

    def tn(*shape, std=0.02):
        t = torch.empty(shape, dtype=torch.float32, device=gen_dev)
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        return t.to(device=device, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    params: Params = {
        "embeddings": {
            "cls_token": tn(1, cfg.num_prefix_tokens, d),
            "position_embeddings": tn(1, cfg.seq_len, d),
            "patch_embed": {"kernel": tn(cfg.patch_dim, d), "bias": zeros(d)},
        },
        "encoder": {
            "ln1": {"scale": ones(l, d), "bias": zeros(l, d)},
            "qkv": {"kernel": tn(l, d, 3 * d), "bias": zeros(l, 3 * d)},
            "out": {"kernel": tn(l, d, d), "bias": zeros(l, d)},
            "ln2": {"scale": ones(l, d), "bias": zeros(l, d)},
            "fc1": {"kernel": tn(l, d, m), "bias": zeros(l, m)},
            "fc2": {"kernel": tn(l, m, d), "bias": zeros(l, d)},
        },
        "ln_final": {"scale": ones(d), "bias": zeros(d)},
    }
    if cfg.num_classes:
        params["classifier"] = {"kernel": tn(d, cfg.num_classes),
                                "bias": zeros(cfg.num_classes)}
    return params


def _check_pixels(pixels: torch.Tensor, cfg: ViTConfig) -> None:
    if tuple(pixels.shape[1:]) != (cfg.num_channels, cfg.image_size,
                                   cfg.image_size) or pixels.dim() != 4:
        raise ValueError(f"pixels {tuple(pixels.shape)} do not match {cfg}")


def embed(params: Params, pixels: torch.Tensor, cfg: ViTConfig, *,
          impl: str | None = None, sp: int | None = None) -> torch.Tensor:
    """Patch embed + prefix tokens + position embeddings:
    ``(B, C, H, W) -> (B, seq_len, D)`` in ``cfg.dtype``. The projection is
    rounded to the dtype first, then the prefix rows are concatenated and
    the positions added in the dtype (``vit_tpu/models/vit.py:115-120``).

    With ``sp``, the result is ``(B, sp, D)`` with zero pad rows: one
    ``embed_fused`` call where ``ops.embed_fused_ok`` takes the geometry
    (``vit_tpu/models/vit.py:104-114``), else the composed embedding
    padded; the numbers are the same."""
    _check_pixels(pixels, cfg)
    b = pixels.shape[0]
    e = params["embeddings"]
    dt = cfg.dtype
    if sp is not None and ops.embed_fused_ok(
            b, cfg.num_patches, cfg.hidden_dim, sp, cfg.num_prefix_tokens):
        pos = e["position_embeddings"].reshape(cfg.seq_len, cfg.hidden_dim)
        cls_row = (e["cls_token"].reshape(cfg.hidden_dim).to(dt)
                   + pos[0].to(dt))
        return ops.embed_fused(
            ops.reference.patchify(pixels.to(dt), cfg.patch_size),
            e["patch_embed"]["kernel"], e["patch_embed"]["bias"], cls_row,
            pos[1:], sp, impl=impl)
    x = ops.patch_embed(pixels.to(dt), e["patch_embed"]["kernel"],
                        e["patch_embed"]["bias"], cfg.patch_size, impl=impl)
    cls = e["cls_token"].to(dt).expand(b, cfg.num_prefix_tokens,
                                       cfg.hidden_dim)
    x = torch.cat([cls, x], dim=1) + e["position_embeddings"].to(dt)
    if sp is not None and sp != cfg.seq_len:
        x = F.pad(x, (0, 0, 0, sp - cfg.seq_len))
    return x


ATTENTIONS = ("flash", "unfused")


def _padded_seq(cfg: ViTConfig, attention: str = "flash") -> int:
    """Encoder token count: on the flash route the real count rounded up to
    a multiple of 16 (197 -> 208 for B/16), the real count on the unfused
    route, as on the JAX package's kernel tier
    (``vit_tpu/models/vit.py:_padded_seq``)."""
    if attention not in ATTENTIONS:
        raise ValueError(f"unknown attention mode {attention!r}")
    if attention == "unfused":
        return cfg.seq_len
    return -(-cfg.seq_len // 16) * 16


def fold_base(params: Params, cfg: ViTConfig) -> torch.Tensor:
    """The ``(sp, D)`` rows ``[cls + pos0 | pos + bias | 0]`` in
    ``cfg.dtype`` that ``encoder_stack_fused`` adds to the patch rows, each
    sum rounded to the dtype (``vit_tpu/models/vit.py:290-295``)."""
    e = params["embeddings"]
    s, d, dt = cfg.seq_len, cfg.hidden_dim, cfg.dtype
    pos = e["position_embeddings"].reshape(s, d).to(dt)
    return torch.cat([e["cls_token"].reshape(1, d).to(dt) + pos[:1],
                      pos[1:] + e["patch_embed"]["bias"].to(dt),
                      pos.new_zeros((_padded_seq(cfg) - s, d))])


def _layers(enc: Params) -> list[Params]:
    """Every layer's params as views of the stacked encoder tensors, each
    tensor unbound once: a backward then stacks each tensor's per-layer
    gradients once, where indexing ``t[i]`` a layer at a time would
    zero-fill a whole ``(L, ...)`` gradient for every layer."""
    unbound = {name: {k: t.unbind(0) for k, t in p.items()}
               for name, p in enc.items()}
    return [{name: {k: ts[i] for k, ts in p.items()}
             for name, p in unbound.items()}
            for i in range(enc["qkv"]["kernel"].shape[0])]


def encoder_block(x: torch.Tensor, lp: Params, cfg: ViTConfig, *,
                  impl: str | None = None, attention: str = "flash",
                  fused: bool = True, seq_len: int | None = None,
                  layer_block: bool = False) -> torch.Tensor:
    """One pre-LN encoder layer on the ``(B, S, D)`` activation, after
    ``vit_tpu/models/vit.py:encoder_block``. ``lp`` holds this layer's
    params; keys at index >= ``seq_len`` are masked (flash only: the
    unfused route takes no padded tokens, as JAX asserts).

    With ``fused=True`` and ``attention="flash"`` each half runs its
    mega-kernel where :func:`ops.attn_plan` or :func:`ops.mlp_plan` says it
    fits; the plans read geometry and dtype only, so every device takes the
    same route. Otherwise the half is composed: each linear is
    ``fused_linear`` (the LN prologue, the residual in its epilogue) with
    ``fused=True``, and ``layernorm`` -> ``matmul`` -> ``add`` with
    ``fused=False``; attention is ``flash_attention`` over the packed QKV
    buffer, or with ``attention="unfused"`` the reference's chain over
    (B*H, S, d): ``matmul3(q, kᵀ) * d**-0.5`` -> ``softmax`` ->
    ``matmul3(p, v)``.

    ``layer_block=True`` (the counterpart of setting JAX's
    ``VIT_TPU_LAYER_PLAN``) runs the whole layer as :func:`ops.layer_block`
    where the mega-kernels apply and :func:`ops.layer_plan` takes the
    geometry: the activation between the halves then stays fp32, where the
    two half kernels round it to the dtype."""
    if attention not in ATTENTIONS:
        raise ValueError(f"unknown attention mode {attention!r}")
    b, s, d = x.shape
    if seq_len is None:
        seq_len = s
    nh, hd = cfg.num_heads, cfg.head_dim
    eps = cfg.layernorm_eps
    mega = fused and attention == "flash"
    if layer_block and mega and ops.layer_plan(b, s, d, cfg.mlp_dim, nh,
                                                x.dtype):
        return ops.layer_block(
            x, lp["ln1"]["scale"], lp["ln1"]["bias"], lp["qkv"]["kernel"],
            lp["qkv"]["bias"], lp["out"]["kernel"], lp["out"]["bias"],
            lp["ln2"]["scale"], lp["ln2"]["bias"], lp["fc1"]["kernel"],
            lp["fc1"]["bias"], lp["fc2"]["kernel"], lp["fc2"]["bias"],
            num_heads=nh, scale=hd ** -0.5, seq_len=seq_len, eps=eps,
            impl=impl)

    def lin(inp, p, act=None, ln=None, res=None):
        if fused:
            return ops.fused_linear(
                inp, p["kernel"], p["bias"], act,
                ln_scale=ln["scale"] if ln else None,
                ln_bias=ln["bias"] if ln else None, eps=eps, residual=res,
                impl=impl)
        h = ops.layernorm(inp, ln["scale"], ln["bias"], eps=eps,
                          impl=impl) if ln else inp
        out = ops.matmul(h, p["kernel"], p["bias"], act, impl=impl)
        return ops.add(out, res, impl=impl) if res is not None else out

    if mega and ops.attn_plan(b, s, d, nh, x.dtype):
        ln1 = lp["ln1"]
        x = ops.attn_block(
            x, ln1["scale"], ln1["bias"], lp["qkv"]["kernel"],
            lp["qkv"]["bias"], lp["out"]["kernel"], lp["out"]["bias"],
            num_heads=nh, scale=hd ** -0.5, seq_len=seq_len, eps=eps,
            impl=impl)
    else:
        xf = x.reshape(b * s, d)
        qkv = lin(xf, lp["qkv"], ln=lp["ln1"])
        if attention == "flash":
            # The kernels read the heads as strided views of the packed
            # [q|k|v] columns; the backward writes the packed gradient.
            ctx = ops.flash_attention_qkv(qkv.view(b, s, 3, nh, hd),
                                          scale=hd ** -0.5, seq_len=seq_len,
                                          impl=impl)
            # The kernel's context is a (B, S, H, hd) buffer: a view.
            ctx = ctx.transpose(1, 2).reshape(b * s, d)
        else:
            if seq_len != s:
                raise ValueError(f"unfused attention takes no padded tokens "
                                 f"({seq_len} real of {s})")
            # K16 takes row-major operands: q, kᵀ and v are copied
            # contiguous over (B*H, S, d), as XLA materialises them (at
            # B=1 a reshape alone would return a strided view).
            heads = qkv.view(b, s, 3, nh, hd)
            q = heads[:, :, 0].transpose(1, 2).contiguous().view(b * nh, s, hd)
            kt = heads[:, :, 1].permute(0, 2, 3, 1).contiguous().view(
                b * nh, hd, s)
            v = heads[:, :, 2].transpose(1, 2).contiguous().view(b * nh, s, hd)
            scores = ops.matmul3(q, kt, scale=hd ** -0.5, impl=impl)
            probs = ops.softmax(scores, impl=impl)
            ctx = ops.matmul3(probs, v, impl=impl).view(b, nh, s, hd)
            ctx = ctx.transpose(1, 2).reshape(b * s, d)
        x = lin(ctx, lp["out"], res=xf).view(b, s, d)

    if mega and ops.mlp_plan(d, cfg.mlp_dim, x.dtype):
        ln2 = lp["ln2"]
        return ops.mlp_block(
            x, ln2["scale"], ln2["bias"], lp["fc1"]["kernel"],
            lp["fc1"]["bias"], lp["fc2"]["kernel"], lp["fc2"]["bias"],
            eps=eps, impl=impl)
    h = lin(x, lp["fc1"], act="gelu", ln=lp["ln2"])
    return lin(h, lp["fc2"], res=x)


def forward(params: Params, pixels: torch.Tensor, cfg: ViTConfig, *,
            impl: str | None = None, attention: str = "flash",
            fused: bool = True, base: torch.Tensor | None = None,
            layer_block: bool = False) -> torch.Tensor:
    """Full ViT forward. Returns, per ``cfg``:

    - hidden states (B, seq_len, D) -- ``pooling="none"``, no classes;
    - pooled embedding (B, D)       -- ``pooling="cls" | "mean"``;
    - logits (B, num_classes)       -- ``num_classes > 0``.

    ``attention`` and ``fused`` pick :func:`encoder_block`'s route, as in
    ``vit_tpu/models/vit.py:forward``; the stack plans apply only to
    ``("flash", True)``, the default, whose route depends on the batch size
    (the module docstring gives it). ``attention="unfused"`` runs at the
    real token count. ``base`` is :func:`fold_base` of ``params``, for a
    caller that serves fixed params and builds it once (``Predictor``
    does); the fused route builds it when it is None. ``layer_block=True``
    asks :func:`encoder_block` for the full-layer kernel on the per-layer
    route; the stack routes still come first, as in JAX.
    """
    s, sp = cfg.seq_len, _padded_seq(cfg, attention)
    b = pixels.shape[0]
    d, nh = cfg.hidden_dim, cfg.num_heads
    geometry = (b, sp, d, cfg.mlp_dim, nh, cfg.dtype)
    eps = cfg.layernorm_eps
    stack = fused and attention == "flash"
    if stack and ops.stack_fused_plan(*geometry, cfg.num_prefix_tokens):
        _check_pixels(pixels, cfg)
        x = ops.encoder_stack_fused(
            ops.reference.patchify(pixels.to(cfg.dtype), cfg.patch_size),
            params["encoder"], params["embeddings"]["patch_embed"]["kernel"],
            fold_base(params, cfg) if base is None else base,
            params["ln_final"], num_heads=nh, sp=sp,
            scale=cfg.head_dim ** -0.5, seq_len=s, eps=eps, impl=impl)
        return _forward_tail(x, params, cfg, s, sp, impl)
    x = embed(params, pixels, cfg, impl=impl, sp=sp)
    if stack and ops.stack_plan(*geometry):
        x = ops.encoder_stack(x, params["encoder"], num_heads=nh,
                              scale=cfg.head_dim ** -0.5, seq_len=s, eps=eps,
                              impl=impl)
    else:
        for lp in _layers(params["encoder"]):
            x = encoder_block(x, lp, cfg, impl=impl, attention=attention,
                              fused=fused, seq_len=s, layer_block=layer_block)
    x = ops.layernorm(x, params["ln_final"]["scale"],
                      params["ln_final"]["bias"], eps=cfg.layernorm_eps,
                      impl=impl)
    return _forward_tail(x, params, cfg, s, sp, impl)


def _forward_tail(x: torch.Tensor, params: Params, cfg: ViTConfig, s: int,
                  sp: int, impl: str | None) -> torch.Tensor:
    """After the final LN: slice the pad off, then pool or classify."""
    if sp != s:
        x = x[:, :s]
    if cfg.num_classes:
        pooled = x[:, 0] if cfg.pooling in ("none", "cls") else x.mean(dim=1)
        c = params["classifier"]
        return ops.matmul(pooled.contiguous(), c["kernel"], c["bias"],
                          impl=impl)
    if cfg.pooling == "cls":
        return x[:, 0]
    if cfg.pooling == "mean":
        return x.mean(dim=1)
    return x


def forward_with_intermediates(params: Params, pixels: torch.Tensor,
                               cfg: ViTConfig, *, impl: str | None = None,
                               attention: str = "flash", fused: bool = True,
                               layer_block: bool = False):
    """Forward that also returns every layer's hidden states: ``(final,
    hiddens)`` with ``hiddens`` the embedding output followed by each
    encoder layer's output (pre-final-LN), each (B, seq_len, D) -- the
    convention of HF ``output_hidden_states=True``. One
    :func:`encoder_block` a layer on the route of ``attention``, ``fused``
    and ``layer_block``."""
    s, sp = cfg.seq_len, _padded_seq(cfg, attention)
    x = embed(params, pixels, cfg, impl=impl)
    hiddens = [x]
    x = F.pad(x, (0, 0, 0, sp - s))
    for lp in _layers(params["encoder"]):
        x = encoder_block(x, lp, cfg, impl=impl, attention=attention,
                          fused=fused, seq_len=s, layer_block=layer_block)
        hiddens.append(x[:, :s])
    final = ops.layernorm(x, params["ln_final"]["scale"],
                          params["ln_final"]["bias"], eps=cfg.layernorm_eps,
                          impl=impl)
    return final[:, :s], hiddens


def make_forward(cfg: ViTConfig, *, impl: str | None = None,
                 attention: str = "flash", fused: bool = True,
                 layer_block: bool = False):
    """:func:`forward` with the config, implementation and route bound."""
    return functools.partial(forward, cfg=cfg, impl=impl, attention=attention,
                             fused=fused, layer_block=layer_block)


class ViT(nn.Module):
    """Thin module around :func:`forward` that holds the params dict on an
    explicit device."""

    def __init__(self, params: Params, cfg: ViTConfig, *,
                 device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = to_device(params, self.device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return forward(self.params, pixels.to(self.device), self.cfg)
