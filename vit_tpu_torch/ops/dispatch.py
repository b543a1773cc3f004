"""Implementation dispatch for the op library (counterpart of
``vit_tpu/ops/dispatch.py``).

Every public op in :mod:`vit_tpu_torch.ops` has two implementations:

- ``"torch"`` -- the plain PyTorch version (:mod:`vit_tpu_torch.ops.reference`);
- ``"cuda"``  -- the hand-written kernel (``vit_tpu_torch/csrc/``).

``impl=None`` picks by where the tensor lies: the kernel for a CUDA tensor,
the plain version for a CPU tensor. There is no environment variable and no
interpret mode, and nothing falls back: ``"cuda"`` with a tensor that is not
on a CUDA device raises.

The differentiable ops differ in how they are differentiated:
``impl="torch"`` runs the plain versions under PyTorch's own autograd (the
oracle, like JAX's ``impl="xla"``); ``None`` and ``"cuda"`` run the
``torch.autograd.Function``\\ s of :mod:`vit_tpu_torch.ops.autograd` (JAX's
custom VJPs), whose kernel slots :func:`kernel_fn` fills by device.
"""

from __future__ import annotations

import torch

VALID_IMPLS = ("torch", "cuda")


def resolve_impl(impl: str | None, x: torch.Tensor) -> str:
    """The implementation that runs an op on ``x``."""
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {x.device}")
    return impl


def check_impl(impl: str | None) -> str | None:
    """``impl`` if it is a valid choice; raise otherwise."""
    if impl is not None and impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    return impl


#: The module under ``vit_tpu_torch.ops.cuda`` that wraps each kernel; the
#: wrapper has the name and signature of the plain version in
#: :mod:`vit_tpu_torch.ops.reference`.
_CUDA_MODULES = {
    "layernorm": "layernorm", "layernorm_stats": "layernorm",
    "matmul": "matmul", "fused_linear": "matmul",
    "flash_attention": "attention", "flash_attention_bwd": "attention",
    "mlp_block": "block", "attn_block": "block", "embed_fused": "embed",
    "encoder_stack": "stack", "encoder_stack_fused": "stack",
    "quantize_rows": "quant", "matmul_i8": "quant", "attn_block_q": "quant",
    "mlp_block_i8dot": "quant", "encoder_stack_q": "stack",
    "add": "elementwise", "softmax": "elementwise", "matmul3": "matmul3",
    "mlp_block_q": "quant", "attn_block_partial": "block",
    "attn_block_q_partial": "quant", "layer_block": "block",
    "patchify": "patching",
}


def kernel_fn(name: str, impl: str | None, x: torch.Tensor):
    """The function that fills kernel slot ``name`` for ``x``: the CUDA
    wrapper where :func:`resolve_impl` gives ``"cuda"``, else the plain
    version of the same name and signature."""
    from vit_tpu_torch.ops import reference
    if resolve_impl(impl, x) == "torch":
        return getattr(reference, name)
    import importlib
    mod = importlib.import_module(
        f"vit_tpu_torch.ops.cuda.{_CUDA_MODULES[name]}")
    return getattr(mod, name)
