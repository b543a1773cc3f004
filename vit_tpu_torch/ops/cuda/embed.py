"""Fused embedding kernel K8 (``csrc/embed.cu``), the counterpart of
``vit_tpu/ops/pallas/patch_embed.py:embed_fused``: K2's GEMM over the patch
rows with an epilogue that writes the padded token matrix directly. It
runs on K2's ``wgmma`` tile of its dtype wherever :func:`embed_tile` says
K2 would: in bf16 ``csrc/gemm_wgmma.cuh``'s (the epilogue's ``EMB`` form:
bias, cast, ``+ pos`` and the token row map in K2's epilogue, the CLS and
pad rows from the block that walks each column tile's first row tile), in
fp32 ``csrc/gemm_tf32.cuh``'s three-pass TF32 walk with the same epilogue
(``Tf32Embed``); elsewhere on ``gemm_tile.cuh``'s tile with the same
epilogue."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.cuda.matmul import gemm_path


def embed_tile(patches: torch.Tensor, w: torch.Tensor) -> str:
    """The tile ``vit_embed_fused`` runs the contiguous ``(B, N, K)``
    patches and ``(K, D)`` weight on: :func:`gemm_path`'s choice for K2 on
    the same ``(B*N, K) @ (K, D)`` operands -- ``"wgmma"`` (the dtype's
    ``wgmma`` tile with K8's epilogue: bf16 ``EMB``, fp32 the three-pass
    TF32 walk), ``"wmma"`` (bf16 where TMA cannot read them, as H/14's K =
    588) or ``"ffma"`` (fp32 on a misaligned base or a K or D that is not
    a multiple of 4). ``csrc/matmul_wgmma.cu:wgmma_takes`` and
    ``csrc/matmul_tf32.cu:tf32_takes`` apply the same rule in the kernel
    library."""
    b, n, k = patches.shape
    d = w.shape[1]
    return gemm_path(b * n, d, k, patches.dtype, False, False,
                     (patches.data_ptr(), w.data_ptr()), ((k, 1), (d, 1)))


def embed_fused(patches: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                cls_row: torch.Tensor, pos: torch.Tensor,
                sp: int) -> torch.Tensor:
    """``(B, N, K)`` CUDA patches -> ``(B, sp, D)`` tokens: row 0
    ``cls_row``, rows 1..N ``(patches @ w + bias)`` rounded, plus ``pos``,
    the rest zeros. ``w`` (K, D), ``bias`` and ``cls_row`` (D,), ``pos``
    (N, D)."""
    _build.check_tensor(patches, "patches", patches)
    if patches.dim() != 3:
        raise ValueError(f"patches shape {tuple(patches.shape)} is not "
                         "(B, N, K)")
    b, n, k = patches.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w shape {tuple(w.shape)} does not take K={k}")
    d = w.shape[1]
    for t, name, shape in ((w, "w", (k, d)), (bias, "bias", (d,)),
                           (cls_row, "cls_row", (d,)), (pos, "pos", (n, d))):
        _build.check_tensor(t, name, patches, shape)
    if b * n * k * d == 0:
        raise ValueError(f"embed_fused of an empty operand "
                         f"{tuple(patches.shape)} @ {tuple(w.shape)}")
    if sp < n + 1:
        raise ValueError(f"sp={sp} has no room for {n} patches and the CLS "
                         "row")
    out = torch.empty((b, sp, d), dtype=patches.dtype, device=patches.device)
    _build.launch("vit_embed_fused", patches, w, bias, cls_row, pos, out, b,
                  n, k, d, sp, like=patches)
    count_launch("embed_fused")
    return out
