"""Multi-rank execution (counterpart of ``vit_tpu/parallel``): a
``('data', 'model')`` mesh over ``torch.distributed`` process groups, batch
data parallelism over 'data' and Megatron tensor parallelism over 'model'
on the kernel tier (:mod:`vit_tpu_torch.parallel.tp`). Sharded checkpoints
(``save_sharded`` / ``load_sharded``) are not ported yet."""

from vit_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    batch_shard,
    gather_batch,
    make_mesh,
    replicate,
    shard_params,
)
from vit_tpu_torch.parallel.tp import (
    make_tp_forward,
    prepare_tp_params,
    repack_qkv_headmajor,
)

__all__ = ["Mesh", "make_mesh", "shard_params", "batch_shard",
           "gather_batch", "replicate", "all_reduce", "make_tp_forward",
           "prepare_tp_params", "repack_qkv_headmajor"]
