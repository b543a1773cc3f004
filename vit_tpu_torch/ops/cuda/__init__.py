"""Wrappers of the hand-written Hopper kernels in ``vit_tpu_torch/csrc/``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches its kernel on PyTorch's current
stream through the ``ctypes``-loaded library (:mod:`._build`), raises if
the launch reports an error, and only then adds one to its launch count.
The kernels are built from the repository's sources on first use.

The shard forms of the tensor-parallel path's one-kernel MLPs count apart
from their whole-block forms (``mlp_block_partial`` and so on). A block
made of several launches (``attn_block``, ``attn_block_q`` and their
shard forms) has no count of its own: its kernels count theirs;
``layer_block`` counts its last launch, K18, and its first three count as
``attn_block``'s do.

The counts show that a run went through the kernels:
:func:`reset_launch_counts` before it, :func:`launch_counts` after.
"""

from __future__ import annotations

#: The kernels, by the name their wrapper counts launches under.
KERNELS = ("layernorm", "matmul", "attention", "mlp_block", "layernorm_stats",
           "fused_linear", "flash_attention", "embed_fused", "encoder_stack",
           "encoder_stack_fused", "quantize_rows", "matmul_i8",
           "mlp_block_i8dot", "encoder_stack_q", "flash_attention_bwd",
           "add", "softmax", "matmul3", "mlp_block_q", "mlp_block_partial",
           "mlp_block_i8dot_partial", "mlp_block_q_partial", "layer_block",
           "patchify", "print_if", "minimal_matmul")

_counts = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for name in _counts:
        _counts[name] = 0


def count_launch(name: str) -> None:
    """Called by a wrapper right after its kernel launched without error."""
    _counts[name] += 1
