"""ViT forward graph (counterpart of ``vit_tpu/models/vit.py``).

Plain functions on a params dict, plus a thin :class:`ViT` module. The
layout is the JAX package's: linear weights ``(in, out)``, encoder tensors
stacked along a leading ``num_layers`` axis (layer l's weights are the
contiguous view ``w[l]``, so no per-layer copy is made), fused ``(D, 3D)``
QKV.

Every batch size takes the JAX package's throughput route
(``vit_tpu/models/vit.py:301-365``): composed embed, zero-pad the tokens to
a multiple of 16 (197 -> 208 for B/16), per layer ``attn_block`` then
``mlp_block``, final ``layernorm``, slice back to the real tokens, then
pool or classify. Padded keys are masked inside attention and every other
op is row-wise, so the pad rows never touch the real ones. With CUDA
tensors each op runs its hand-written kernel; with CPU tensors (or
``impl="torch"``) its plain PyTorch version.
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
                device: torch.device | str = "cpu") -> Params:
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


def embed(params: Params, pixels: torch.Tensor, cfg: ViTConfig, *,
          impl: str | None = None) -> torch.Tensor:
    """Patch embed + prefix tokens + position embeddings:
    ``(B, C, H, W) -> (B, seq_len, D)`` in ``cfg.dtype``. The projection is
    rounded to the dtype first, then the prefix rows are concatenated and
    the positions added in the dtype (``vit_tpu/models/vit.py:115-120``)."""
    b, c, h, w = pixels.shape
    if (c, h, w) != (cfg.num_channels, cfg.image_size, cfg.image_size):
        raise ValueError(f"pixels {tuple(pixels.shape)} do not match {cfg}")
    e = params["embeddings"]
    dt = cfg.dtype
    x = ops.patch_embed(pixels.to(dt), e["patch_embed"]["kernel"],
                        e["patch_embed"]["bias"], cfg.patch_size, impl=impl)
    cls = e["cls_token"].to(dt).expand(b, cfg.num_prefix_tokens,
                                       cfg.hidden_dim)
    x = torch.cat([cls, x], dim=1)
    return x + e["position_embeddings"].to(dt)


def _padded_seq(cfg: ViTConfig) -> int:
    """Encoder token count: the real count rounded up to a multiple of 16
    (197 -> 208 for B/16), as on the JAX package's kernel route."""
    return -(-cfg.seq_len // 16) * 16


def _encoder_layer(x: torch.Tensor, enc: Params, i: int, cfg: ViTConfig,
                   impl: str | None) -> torch.Tensor:
    """Layer ``i`` of the stacked encoder: ``attn_block`` then ``mlp_block``
    on the padded ``(B, sp, D)`` activation."""
    eps = cfg.layernorm_eps
    x = ops.attn_block(
        x, enc["ln1"]["scale"][i], enc["ln1"]["bias"][i],
        enc["qkv"]["kernel"][i], enc["qkv"]["bias"][i],
        enc["out"]["kernel"][i], enc["out"]["bias"][i],
        num_heads=cfg.num_heads, scale=cfg.head_dim ** -0.5,
        seq_len=cfg.seq_len, eps=eps, impl=impl)
    return ops.mlp_block(
        x, enc["ln2"]["scale"][i], enc["ln2"]["bias"][i],
        enc["fc1"]["kernel"][i], enc["fc1"]["bias"][i],
        enc["fc2"]["kernel"][i], enc["fc2"]["bias"][i], eps=eps, impl=impl)


def forward(params: Params, pixels: torch.Tensor, cfg: ViTConfig, *,
            impl: str | None = None) -> torch.Tensor:
    """Full ViT forward. Returns, per ``cfg``:

    - hidden states (B, seq_len, D) -- ``pooling="none"``, no classes;
    - pooled embedding (B, D)       -- ``pooling="cls" | "mean"``;
    - logits (B, num_classes)       -- ``num_classes > 0``.
    """
    s, sp = cfg.seq_len, _padded_seq(cfg)
    x = F.pad(embed(params, pixels, cfg, impl=impl), (0, 0, 0, sp - s))
    for i in range(cfg.num_layers):
        x = _encoder_layer(x, params["encoder"], i, cfg, impl)
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
                               cfg: ViTConfig, *, impl: str | None = None):
    """Forward that also returns every layer's hidden states: ``(final,
    hiddens)`` with ``hiddens`` the embedding output followed by each
    encoder layer's output (pre-final-LN), each (B, seq_len, D) -- the
    convention of HF ``output_hidden_states=True``."""
    s, sp = cfg.seq_len, _padded_seq(cfg)
    x = embed(params, pixels, cfg, impl=impl)
    hiddens = [x]
    x = F.pad(x, (0, 0, 0, sp - s))
    for i in range(cfg.num_layers):
        x = _encoder_layer(x, params["encoder"], i, cfg, impl)
        hiddens.append(x[:, :s])
    final = ops.layernorm(x, params["ln_final"]["scale"],
                          params["ln_final"]["bias"], eps=cfg.layernorm_eps,
                          impl=impl)
    return final[:, :s], hiddens


def make_forward(cfg: ViTConfig, *, impl: str | None = None):
    """:func:`forward` with the config and implementation bound."""
    return functools.partial(forward, cfg=cfg, impl=impl)


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
