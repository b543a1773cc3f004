"""Tiled GEMM kernel K2 and its LN-prologue form K6 (``csrc/matmul.cu``),
the counterparts of ``vit_tpu/ops/pallas/matmul.py:matmul`` and
``fused_linear``. K2 has one extension: an optional residual added in fp32
before the single cast, which the split ``attn_block`` needs to keep
``_attn_core``'s rounding.

K2 runs on one of two tiles, which :func:`gemm_path` picks from shape and
alignment alone: a ``wgmma`` tile fed by TMA, which reads an operand given
as the transpose of a contiguous matrix where it lies -- in bf16
``csrc/gemm_wgmma.cuh``'s, in fp32 ``csrc/gemm_tf32.cuh``'s (the three-pass
TF32 split of ``csrc/tf32_split.cuh``, JAX's ``Precision.HIGHEST``
counterpart) -- or ``gemm_tile.cuh``'s tile (bf16 ``wmma``, true-fp32
FFMA), which reads contiguous operands only: the wrapper copies a
transposed operand for it. K6 runs on the dtype's ``wgmma`` tile or on
``gemm_tile.cuh``'s, by the same rule on its contiguous operands, which
``vit_fused_linear`` applies itself before the launch
(:func:`fused_linear_tile` asks it): on the bf16 ``wgmma`` tile x's raw box
arrives by TMA and the producer warpgroup's three idle warps normalise it
in place in shared memory before the consumers' ``wgmma`` reads it; on the
fp32 one (``csrc/gemm_tf32.cuh``) each consumer thread normalises its A
fragments as it loads them from the raw box, before the three-pass split;
on ``gemm_tile.cuh``'s each element is normalised as it is staged."""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.cuda.layernorm import layernorm_stats

#: The C interface's tile code of each :func:`gemm_path` result.
TILES = {"ffma": 0, "wmma": 0, "wgmma": 1}


def gemm_path(m: int, n: int, k: int, dtype: torch.dtype, trans_a: bool,
              trans_b: bool, ptrs: tuple[int, int],
              strides: tuple[tuple[int, ...], tuple[int, ...]]) -> str:
    """The tile K2 runs ``(m, k) @ (k, n)`` on: ``"wgmma"`` where TMA can
    read both operands -- each base (``ptrs``, bytes) 16-byte aligned,
    each operand's row stride in its storage a multiple of 16 bytes (8
    bf16, 4 fp32 elements) -- else ``"wmma"`` in bf16, ``"ffma"`` in fp32
    (true fp32). The fp32 ``wgmma`` tile runs the three-pass TF32 split
    (``csrc/gemm_tf32.cuh``), which holds the fp32 bars as JAX's
    ``Precision.HIGHEST`` does. ``strides`` are the two 2-D operands'
    strides as given; with ``trans_a`` x is the view of a contiguous (k, m)
    matrix, whose rows are ``strides[0][1]`` apart, with ``trans_b`` w that
    of an (n, k) one: the ``wgmma`` tiles read both views where they lie."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K2 takes float32 or bfloat16, not {dtype}")
    if min(m, n, k) <= 0:
        raise ValueError(f"matmul of an empty operand ({m}, {k}) @ ({k}, {n})")
    per_16b = 16 // dtype.itemsize
    lda = strides[0][1] if trans_a else strides[0][0]
    ldb = strides[1][1] if trans_b else strides[1][0]
    if all(p % 16 == 0 for p in ptrs) and lda % per_16b == 0 \
            and ldb % per_16b == 0:
        return "wgmma"
    return "ffma" if dtype == torch.float32 else "wmma"


def _transposed(t: torch.Tensor) -> bool:
    """Whether K2 reads ``t`` as the ``.t()`` view of a contiguous 2-D
    matrix: ``t`` is one and not itself contiguous, or it is both, which
    only a column (r, 1) with r > 1 or a row can be. Such a column (``x.t()``
    of a one-row x) is read as its transpose's one row: as an (r, 1) matrix
    its rows would be 1 element apart, which TMA cannot read."""
    return (t.dim() == 2 and t.t().is_contiguous()
            and (not t.is_contiguous() or t.shape[1] < t.shape[0]))


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
           activation: str | None, residual: torch.Tensor | None):
    """Check the operands of a GEMM; return ``(m, n, k, out_shape)``. x and
    w are contiguous or transposed views of contiguous 2-D matrices."""
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    _build.check_tensor(x, "x", x, contiguous=not _transposed(x))
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    _build.check_tensor(w, "w", x, (k, n), contiguous=not _transposed(w))
    if bias is not None:
        _build.check_tensor(bias, "bias", x, (n,))
    out_shape = (*x.shape[:-1], n)
    if residual is not None:
        _build.check_tensor(residual, "residual", x, out_shape)
    m = x.numel() // k if k else 0
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"matmul of an empty operand {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    return m, n, k, out_shape


def k2_operands(x: torch.Tensor, w: torch.Tensor, m: int, k: int):
    """What K2 launches for ``x @ w``: ``(x, w, trans_a, trans_b, path)``
    with ``path`` from :func:`gemm_path`. A transposed operand goes as it
    lies to the wgmma tile, as a contiguous copy to the other; an (..., K)
    x goes as its (m, K) view. :func:`gemm_path` sees the row strides the
    launcher reads the operands with: K, N, or with a transpose M, K."""
    ta, tb = _transposed(x), _transposed(w)
    if not ta:
        x = x.reshape(m, k)
    n = w.shape[1]
    path = gemm_path(m, n, k, x.dtype, ta, tb, (x.data_ptr(), w.data_ptr()),
                     ((1, m) if ta else (k, 1), (1, k) if tb else (n, 1)))
    if path != "wgmma":
        x, w, ta, tb = x.contiguous(), w.contiguous(), False, False
    return x, w, ta, tb, path


def _k2(x, w, bias, residual, out, m, n, k, gelu: int) -> None:
    """Launch K2 on the tile :func:`gemm_path` picks (:func:`k2_operands`)."""
    x, w, ta, tb, path = k2_operands(x, w, m, k)
    _build.launch("vit_matmul", x, w, bias, residual, out, m, n, k, gelu,
                  int(ta), int(tb), TILES[path], like=x)


def matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           activation: str | None = None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``(..., K) @ (K, N)`` on CUDA tensors, fp32 accumulation, then
    ``+ bias``, GELU and ``+ residual`` in fp32, one cast to ``x.dtype``.
    ``residual`` has the output's shape ``(..., N)``. x (2-D) and w may be
    ``.t()`` views of contiguous matrices."""
    m, n, k, out_shape = _check(x, w, bias, activation, residual)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _k2(x, w, bias, residual, out, m, n, k, int(activation == "gelu"))
    count_launch("matmul")
    return out


def fused_linear_tile(x: torch.Tensor, w: torch.Tensor) -> str:
    """The tile ``vit_fused_linear`` picks for contiguous x and w before it
    launches (``csrc/matmul.cu:vit_fused_linear_tile``): ``"wgmma"`` (the
    dtype's: bf16 ``gemm_wgmma.cuh``'s, fp32 ``gemm_tf32.cuh``'s three-pass
    TF32 split), or ``gemm_tile.cuh``'s (``"wmma"`` in bf16, ``"ffma"`` in
    fp32). The rule is :func:`gemm_path`'s for K2 on the same contiguous
    operands."""
    k, n = w.shape
    tile = _build.library().vit_fused_linear_tile(
        x.data_ptr(), w.data_ptr(), n, k, _build.DTYPE_CODES[x.dtype])
    if tile:
        return "wgmma"
    return "ffma" if x.dtype == torch.float32 else "wmma"


def fused_linear(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 activation: str | None = None, *,
                 ln_scale: torch.Tensor | None = None,
                 ln_bias: torch.Tensor | None = None, eps: float = 1e-12,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(LN(x) @ w + bias) + residual`` on CUDA tensors. With
    ``ln_scale`` and ``ln_bias`` it is two launches, as in JAX: K5 for the
    row stats, then K6 on the tile :func:`fused_linear_tile` names; without
    them, one launch of K2, whose epilogue is the same."""
    m, n, k, out_shape = _check(x, w, bias, activation, residual)
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    gelu = int(activation == "gelu")
    if ln_scale is None:
        _k2(x, w, bias, residual, out, m, n, k, gelu)
    else:
        _build.check_tensor(ln_scale, "ln_scale", x, (k,))
        _build.check_tensor(ln_bias, "ln_bias", x, (k,))
        x, w = x.contiguous(), w.contiguous()
        mu, rstd = layernorm_stats(x, eps=eps)
        _build.launch("vit_fused_linear", x, w, bias, residual, mu, rstd,
                      ln_scale, ln_bias, out, m, n, k, gelu, like=x)
    count_launch("fused_linear")
    return out
