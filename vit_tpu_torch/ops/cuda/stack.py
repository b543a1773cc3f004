"""Whole-encoder kernel K9 (``csrc/encoder_stack.cu``) in its two forms,
the counterparts of ``vit_tpu/ops/pallas/block.py:encoder_stack`` and
``encoder_stack_fused``: one cooperative persistent launch runs every
layer, and with the fold also the patch embed and the final LN.

The wrapper allocates every buffer the kernel writes (the working
activation, the packed QKV, the context, the MLP hidden, and for the fold
the fp32 sum and the output) with ``torch.empty``; the kernel never writes
its inputs. If the card cannot hold the whole grid at once, the cooperative
launch is refused and the wrapper raises: there is no fallback to the
per-layer route. The two forms count their launches apart.

:func:`encoder_stack_q` runs the same kernel on weight-only int8 weights
(``vit_tpu/ops/pallas/block.py:encoder_stack_q``): the four projections
int8 with fp32 per-column scales, everything else in the dtype. It counts
as ``encoder_stack_q``.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.cuda.block import MAX_SMEM, attention_smem_bytes

#: The stacked encoder tensors in the kernel's argument order, with each
#: one's shape after the leading num_layers axis (D model width, M MLP).
_WEIGHTS = (("ln1", "scale", "D"), ("ln1", "bias", "D"),
            ("qkv", "kernel", "D,3D"), ("qkv", "bias", "3D"),
            ("out", "kernel", "D,D"), ("out", "bias", "D"),
            ("ln2", "scale", "D"), ("ln2", "bias", "D"),
            ("fc1", "kernel", "D,M"), ("fc1", "bias", "M"),
            ("fc2", "kernel", "M,D"), ("fc2", "bias", "D"))


def _weights(enc, d: int, like: torch.Tensor, *, quantized: bool = False):
    """The twelve stacked tensors, checked; returns them, the number of
    layers and the MLP width. With ``quantized``, each projection's
    ``kernel`` is ``{"q": int8, "scale": fp32}``: its ``q`` takes the
    kernel's place and the four scales follow the twelve."""
    def kernel(group):
        k = enc[group]["kernel"]
        return k["q"] if quantized else k

    fc1 = kernel("fc1")
    if fc1.dim() != 3 or fc1.shape[1] != d:
        raise ValueError(f"fc1 kernel shape {tuple(fc1.shape)} does not take "
                         f"D={d}")
    layers, mlp = fc1.shape[0], fc1.shape[2]
    if layers == 0:
        raise ValueError("encoder_stack of an encoder without layers")
    sizes = {"D": d, "3D": 3 * d, "M": mlp}
    out, scales = [], []
    for group, name, dims in _WEIGHTS:
        dims = [sizes[s] for s in dims.split(",")]
        if name == "kernel" and quantized:
            q, sc = kernel(group), enc[group]["kernel"]["scale"]
            _build.check_tensor(q, f"{group}.kernel.q", like,
                                (layers, *dims), dtype=torch.int8)
            _build.check_tensor(sc, f"{group}.kernel.scale", like,
                                (layers, dims[-1]), dtype=torch.float32)
            out.append(q)
            scales.append(sc)
            continue
        t = enc[group][name]
        _build.check_tensor(t, f"{group}.{name}", like, (layers, *dims))
        out.append(t)
    return out + scales, layers, mlp


def _check_attention(sp: int, d: int, num_heads: int,
                     like: torch.Tensor) -> int:
    """Raise unless the attention phase takes ``num_heads`` heads of D at
    ``sp`` tokens; returns the head width. The budget is the FFMA tile's
    in both dtypes, as ``ops.attn_plan``'s is: bf16 runs the tensor-core
    core, which needs less wherever this admits
    (``csrc/encoder_stack.cu:stack_attn_smem``)."""
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"D={d} not divisible by {num_heads} heads")
    hd = d // num_heads
    smem = attention_smem_bytes(sp, hd, like.element_size())
    if smem > MAX_SMEM:
        raise ValueError(f"the attention routine does not take head_dim {hd} "
                         f"at {sp} tokens: {smem} B of shared memory, more "
                         f"than {MAX_SMEM}")
    return hd


#: Slices of K the bf16 kernel may split the out-projection and fc2 into
#: (``csrc/stack_wgmma.cuh``: ``kMaxSplits``). Their fp32 sums go to the
#: packed QKV buffer, which no phase reads then, so it is sized for them.
MAX_SPLITS = 8


def qkv_buffer(m: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """The packed QKV scratch, (m, 3d) at its start; in bf16 with room for
    the split-K workspace of the wgmma phases, ``MAX_SPLITS`` fp32 slices
    of (m, d)."""
    n = 3 * m * d
    if like.dtype == torch.bfloat16:
        n = max(n, MAX_SPLITS * m * d * 2)
    return torch.empty(n, dtype=like.dtype, device=like.device)


def _scratch(m: int, d: int, mlp: int, like: torch.Tensor):
    """The packed QKV (with its workspace), context and MLP hidden
    buffers."""
    kw = dict(dtype=like.dtype, device=like.device)
    return (qkv_buffer(m, d, like), torch.empty((m, d), **kw),
            torch.empty((m, mlp), **kw))


def encoder_stack(x: torch.Tensor, enc, *, num_heads: int,
                  scale: float | None = None, seq_len: int | None = None,
                  eps: float = 1e-12) -> torch.Tensor:
    """Every layer of the stacked encoder ``enc`` on a CUDA tensor ``x``
    (B, sp, D), one launch; keys at index >= ``seq_len`` are masked."""
    _build.check_tensor(x, "x", x)
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"x shape {tuple(x.shape)} is not (B, sp, D)")
    b, sp, d = x.shape
    weights, layers, mlp = _weights(enc, d, x)
    hd = _check_attention(sp, d, num_heads, x)
    seq_len = sp if seq_len is None else seq_len
    if not 0 < seq_len <= sp:
        raise ValueError(f"seq_len {seq_len} outside (0, {sp}]")
    work = x.clone()  # the kernel updates the activation in place
    _build.launch("vit_encoder_stack", work, *_scratch(b * sp, d, mlp, x),
                  None, None, *weights, None, None, None, None, None, b, sp,
                  d, mlp, num_heads, layers, seq_len, 0, 0,
                  float(hd ** -0.5 if scale is None else scale), float(eps),
                  0, like=x)
    count_launch("encoder_stack")
    return work


def encoder_stack_fused(patches: torch.Tensor, enc, wemb: torch.Tensor,
                        base: torch.Tensor, lnf, *, num_heads: int, sp: int,
                        scale: float | None = None,
                        seq_len: int | None = None,
                        eps: float = 1e-12) -> torch.Tensor:
    """Patch embed, every layer and the final LN on CUDA ``patches``
    (B, N, K), one launch: returns (B, sp, D), pad rows included. ``wemb``
    (K, D); ``base`` (sp, D) the rows ``[cls + pos0 | pos + bias | 0]``;
    ``lnf`` the final LN's ``{scale, bias}``."""
    _build.check_tensor(patches, "patches", patches)
    if patches.dim() != 3 or patches.numel() == 0:
        raise ValueError(f"patches shape {tuple(patches.shape)} is not "
                         "(B, N, K)")
    b, n, k = patches.shape
    if wemb.dim() != 2 or wemb.shape[0] != k:
        raise ValueError(f"wemb shape {tuple(wemb.shape)} does not take "
                         f"K={k}")
    d = wemb.shape[1]
    if sp < n + 1:
        raise ValueError(f"sp={sp} has no room for {n} patches and the CLS "
                         "row")
    for t, name, shape in ((wemb, "wemb", (k, d)), (base, "base", (sp, d)),
                           (lnf["scale"], "lnf.scale", (d,)),
                           (lnf["bias"], "lnf.bias", (d,))):
        _build.check_tensor(t, name, patches, shape)
    weights, layers, mlp = _weights(enc, d, patches)
    hd = _check_attention(sp, d, num_heads, patches)
    seq_len = n + 1 if seq_len is None else seq_len
    if not 0 < seq_len <= sp:
        raise ValueError(f"seq_len {seq_len} outside (0, {sp}]")
    m = b * sp
    work = torch.empty((m, d), dtype=patches.dtype, device=patches.device)
    acc = torch.empty((m, d), dtype=torch.float32, device=patches.device)
    out = torch.empty((b, sp, d), dtype=patches.dtype, device=patches.device)
    _build.launch("vit_encoder_stack", work, *_scratch(m, d, mlp, patches),
                  acc, out, *weights, patches, wemb, base, lnf["scale"],
                  lnf["bias"], b, sp, d, mlp, num_heads, layers, seq_len, n,
                  k, float(hd ** -0.5 if scale is None else scale),
                  float(eps), 1, like=patches)
    count_launch("encoder_stack_fused")
    return out


def encoder_stack_q(x: torch.Tensor, enc, *, num_heads: int,
                    scale: float | None = None, seq_len: int | None = None,
                    eps: float = 1e-12) -> torch.Tensor:
    """Every layer of the weight-only int8 encoder ``enc`` on a CUDA tensor
    ``x`` (B, sp, D), one launch of K9 on int8 weight tiles; keys at index
    >= ``seq_len`` are masked."""
    _build.check_tensor(x, "x", x)
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"x shape {tuple(x.shape)} is not (B, sp, D)")
    b, sp, d = x.shape
    weights, layers, mlp = _weights(enc, d, x, quantized=True)
    hd = _check_attention(sp, d, num_heads, x)
    seq_len = sp if seq_len is None else seq_len
    if not 0 < seq_len <= sp:
        raise ValueError(f"seq_len {seq_len} outside (0, {sp}]")
    work = x.clone()  # the kernel updates the activation in place
    _build.launch("vit_encoder_stack_q", work, *_scratch(b * sp, d, mlp, x),
                  *weights, b, sp, d, mlp, num_heads, layers, seq_len,
                  float(hd ** -0.5 if scale is None else scale), float(eps),
                  like=x)
    count_launch("encoder_stack_q")
    return work
