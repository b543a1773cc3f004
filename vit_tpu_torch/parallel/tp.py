"""Tensor-parallel forward on the kernel tier (counterpart of
``vit_tpu/parallel/tp_pallas.py``).

The Megatron decomposition of ``tp_pallas.py:make_tp_forward``, written
out over the mesh's process groups:

- **Attention.** Heads split over 'model'. Each rank runs
  ``ops.attn_block_partial`` (B16; int8: ``attn_block_q_partial``, B17):
  LN, its ``heads/model`` QKV columns, attention, its ``D/model`` rows of
  the output projection, a partial sum in ``x.dtype`` with no bias and no
  residual. One all-reduce over the model group sums the partials; the
  output bias and the residual are added once after it.
- **MLP.** fc1 column-split, fc2 row-split. Each rank runs ``mlp_block``
  (K3; int8 ``mlp_block_i8dot`` K12, or ``mlp_block_q`` K17 with
  ``int8_dot=False``) with ``partial_out=True``, then one all-reduce, then
  ``+ x + b2``.
- The embedding, the final LN and the head run whole on every rank, on the
  port's own kernels (JAX computes them in XLA).

So a layer costs two all-reduces over the model group. A batch is split
over 'data' and gathered at the end, so every rank returns the whole
answer.

Where a shard's widths do not fit a mega-kernel, that half is composed from
the port's kernels, never plain torch on the card: ``ops.mlp_plan`` at
``(D, mlp/model)`` gates K3, and the float MLP half otherwise runs
``layernorm`` -> ``matmul(gelu)`` -> ``matmul`` (K1, K2, K2). The int8 MLP
kernels run where ``ops.mlp_q_plan`` takes the shard (``mlp/model`` whole
512-column quant groups). Where D or ``mlp/model`` is not a multiple of
128, JAX has no int8 MLP plan and composes, quantizing the hidden per row
over all of the shard's columns; the port does the same on its kernels:
``quantize_rows`` (with LN) -> ``matmul_i8(gelu)`` -> ``quantize_rows`` ->
``matmul_i8`` (K10, K11, K10, K11). Between the two, JAX's kernel
quantizes the hidden per chunk of its plan's ``ct``, which the port's
fixed group cannot match, so :func:`make_tp_forward` raises (B/16 and
H/14 over model=4: 768 and 1280 columns a shard). The attention partials
take every width: the attention core gives way to K7 where
``ops.attn_plan`` refuses the length, as the model's composed route does.
JAX's gates differ (its partial kernels need ``dl % 128 == 0``); ROADMAP
C lists the difference.

Layout precondition, as in JAX: the packed ``(D, 3D)`` QKV kernel is
``[q|k|v]``, so a contiguous column slice would mix projections;
:func:`prepare_tp_params` repacks it head-major first. A forward that is
not tensor-parallel on repacked params is wrong by design.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_tpu_torch import ops
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models.vit import _forward_tail, _padded_seq, embed
from vit_tpu_torch.parallel.mesh import (Mesh, all_reduce, batch_shard,
                                         gather_batch, shard_params)
from vit_tpu_torch.weights.convert import Params, tree_map


def repack_qkv_headmajor(params: Params, model: int) -> Params:
    """``params`` with the stacked QKV kernel, bias (and int8 scale)
    repacked head-major: ``(L, D, 3D)`` ``[q|k|v]`` becomes ``[q_0|k_0|v_0 |
    ... | q_{m-1}|k_{m-1}|v_{m-1}]``, shard s's block holding its ``D/model``
    columns of each projection, so a contiguous 'model' slice is its own
    ``[q_s|k_s|v_s]`` (``tp_pallas.py:56-85``). The identity for
    ``model == 1``."""
    if model == 1:
        return params

    def cols(a: torch.Tensor) -> torch.Tensor:
        *lead, d3 = a.shape
        a = a.reshape(*lead, 3, model, d3 // 3 // model)
        return a.transpose(-3, -2).reshape(*lead, d3).contiguous()

    qkv = params["encoder"]["qkv"]
    kern = qkv["kernel"]
    kern = ({"q": cols(kern["q"]), "scale": cols(kern["scale"])}
            if isinstance(kern, dict) else cols(kern))
    enc = dict(params["encoder"])
    enc["qkv"] = {"kernel": kern, "bias": cols(qkv["bias"])}
    return {**params, "encoder": enc}


def prepare_tp_params(params: Params, cfg: ViTConfig, mesh: Mesh) -> Params:
    """This rank's head-major-repacked shard of ``params`` (float, or the
    int8 tier's ``quantize_params`` dict) on ``mesh.device``."""
    return shard_params(repack_qkv_headmajor(params, mesh.model), cfg, mesh)


def make_tp_forward(cfg: ViTConfig, mesh: Mesh, *, impl: str | None = None,
                    quant: bool = False, int8_dot: bool = True):
    """The DP x TP forward on the kernel tier: ``fn(tp_params, pixels)``
    with ``tp_params`` from :func:`prepare_tp_params` (of
    ``quantize_params`` weights with ``quant=True``) and ``pixels`` the
    whole ``(B, C, H, W)`` batch on ``mesh.device``, B a multiple of
    'data'. Each rank runs its rows; every rank returns the whole output,
    with the contract of ``vit_tpu_torch.models.vit.forward`` (of
    ``quant.forward_quant`` with ``quant=True``, which it matches to within
    activation-quant noise: each shard quantizes its context rows over its
    own columns). Runs under ``torch.no_grad``; the collectives are the
    module docstring's. ``int8_dot=False`` takes the weight-only int8 MLP
    (K17). With ``quant=True``, a shard of ``mlp/model`` MLP columns that
    is a multiple of 128 but not of the 512-column quant group raises (the
    module docstring says why)."""
    m = mesh.model
    if cfg.num_heads % m or cfg.mlp_dim % m:
        raise ValueError(f"{cfg.num_heads} heads and MLP {cfg.mlp_dim} must "
                         f"split over model={m}")
    nh_l, d = cfg.num_heads // m, cfg.hidden_dim
    mlp_l = cfg.mlp_dim // m
    mega = (ops.mlp_q_plan(d, mlp_l) if quant
            else ops.mlp_plan(d, mlp_l, cfg.dtype))
    if quant and not mega and not (d % 128 or mlp_l % 128):
        raise ValueError(
            f"int8 tensor parallelism at D={d} over model={m}: a shard's "
            f"{mlp_l} MLP columns are not whole quant groups of "
            f"{ops.reference.MLP_GROUP}, and JAX's int8 MLP kernel quantizes "
            "them in chunks of its plan's width, which the port cannot "
            "match; choose a model axis that leaves whole groups")
    s, sp = cfg.seq_len, _padded_seq(cfg)
    eps = cfg.layernorm_eps
    kw = dict(num_heads=nh_l, scale=cfg.head_dim ** -0.5, seq_len=s, eps=eps,
              impl=impl)
    mlp_int8 = ops.mlp_block_i8dot if int8_dot else ops.mlp_block_q

    def attn_partial(x, lp):
        ln, k, o = lp["ln1"], lp["qkv"]["kernel"], lp["out"]["kernel"]
        if quant:
            return ops.attn_block_q_partial(
                x, ln["scale"], ln["bias"], k["q"], k["scale"],
                lp["qkv"]["bias"], o["q"], o["scale"], **kw)
        return ops.attn_block_partial(x, ln["scale"], ln["bias"], k,
                                      lp["qkv"]["bias"], o, **kw)

    def mlp_partial(x, lp):
        ln, b1 = lp["ln2"], lp["fc1"]["bias"]
        k1, k2, b2 = lp["fc1"]["kernel"], lp["fc2"]["kernel"], lp["fc2"]["bias"]
        if quant and mega:
            return mlp_int8(x, ln["scale"], ln["bias"], k1["q"], k1["scale"],
                            b1, k2["q"], k2["scale"], b2, eps=eps,
                            partial_out=True, impl=impl)
        if quant:
            xq, ax = ops.quantize_rows(x, ln_scale=ln["scale"],
                                       ln_bias=ln["bias"], eps=eps, impl=impl)
            h = ops.matmul_i8(xq, ax, k1["q"], k1["scale"], b1, "gelu",
                              out_dtype=x.dtype, impl=impl)
            hq, ah = ops.quantize_rows(h, impl=impl)
            return ops.matmul_i8(hq, ah, k2["q"], k2["scale"],
                                 out_dtype=x.dtype, impl=impl).view(x.shape)
        if mega:
            return ops.mlp_block(x, ln["scale"], ln["bias"], k1, b1, k2, b2,
                                 eps=eps, partial_out=True, impl=impl)
        h = ops.matmul(ops.layernorm(x, ln["scale"], ln["bias"], eps=eps,
                                     impl=impl), k1, b1, "gelu", impl=impl)
        return ops.matmul(h, k2, impl=impl)

    @torch.no_grad()
    def fn(tp_params: Params, pixels: torch.Tensor) -> torch.Tensor:
        x = embed(tp_params, batch_shard(pixels, mesh), cfg, impl=impl)
        x = F.pad(x, (0, 0, 0, sp - s))
        enc = tp_params["encoder"]
        for i in range(cfg.num_layers):
            lp = tree_map(lambda t: t[i], enc)
            y = all_reduce(attn_partial(x, lp), mesh.model_group)
            x = x + y + lp["out"]["bias"]
            z = all_reduce(mlp_partial(x, lp), mesh.model_group)
            x = x + z + lp["fc2"]["bias"]
        x = ops.layernorm(x, tp_params["ln_final"]["scale"],
                          tp_params["ln_final"]["bias"], eps=eps, impl=impl)
        return gather_batch(_forward_tail(x, tp_params, cfg, s, sp, impl),
                            mesh)

    return fn
