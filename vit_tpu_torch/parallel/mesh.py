"""A ``('data', 'model')`` mesh over ``torch.distributed`` and the Megatron
weight split (counterpart of ``vit_tpu/parallel/mesh.py``).

JAX lays a mesh over devices and lets GSPMD place each array by its
``NamedSharding``. Here every rank is one process with one device, and the
mesh is the rank's place in a ``data x model`` grid plus two process
groups: the ranks that share its data index (the model group, over which
the tensor-parallel partial sums are all-reduced) and the ranks that share
its model index (the data group, over which a batch is split and gathered,
and gradients averaged). Rank ``r`` sits at ``(r // model, r % model)``,
the order of JAX's ``np.asarray(devices).reshape(data, model)``.

The caller initialises the process group (``dist.init_process_group``) and
names its backend: NCCL across cards; gloo for several ranks on one card
and on the CPU. This module picks neither the backend nor the device.

:func:`shard_params` is ``param_shardings`` (``mesh.py:50-98``) applied: it
returns this rank's slices under the same rules. QKV and fc1 are
column-split, out and fc2 row-split; LayerNorms, embeddings and the head
are replicated. An int8 ``{"q", "scale"}`` kernel splits ``q`` like the
float kernel, and its per-output-channel scale with the columns (QKV, fc1)
or not at all (out, fc2).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.weights.convert import Params, to_device

#: Split axis of each stacked (L, in, out) encoder kernel: -1 the output
#: columns, 1 the input rows (its bias and scale are then replicated).
COLUMN_SPLIT = ("qkv", "fc1")
ROW_SPLIT = ("out", "fc2")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data x model`` grid of ranks and the groups
    it all-reduces over (``None`` where the axis has size 1, so that no
    collective runs)."""

    data: int
    model: int
    rank: int
    device: torch.device
    model_group: Any = None
    data_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: int = 1, model: int = 1, *,
              device: torch.device | str = "cuda") -> Mesh:
    """This rank's ``('data', 'model')`` mesh over the initialised default
    process group, whose world size must be ``data * model``. Every rank
    calls it with the same sizes: it creates the process groups of every
    row and column of the grid, in one order on all ranks. ``device`` is
    where this rank's params and batches live (a CUDA device without an
    index means the current one). A mesh of one rank needs no process
    group."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = data * model
    if not dist.is_initialized():
        if n == 1:
            return Mesh(1, 1, 0, device)
        raise RuntimeError(f"a {data} x {model} mesh needs an initialised "
                           "process group (dist.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"a {data} x {model} mesh needs {n} ranks, the "
                         f"process group has {world}")
    groups = {}
    if model > 1:
        for i in range(data):
            ranks = list(range(i * model, (i + 1) * model))
            groups[("model", i)] = dist.new_group(ranks)
    if data > 1:
        for j in range(model):
            ranks = list(range(j, n, model))
            groups[("data", j)] = dist.new_group(ranks)
    return Mesh(data, model, rank, device,
                model_group=groups.get(("model", rank // model)),
                data_group=groups.get(("data", rank % model)))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (nothing where it is None) and
    return it. The sum is in ``t``'s dtype, as JAX's ``lax.psum``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def batch_shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch: the leading axis split evenly over
    'data' and replicated over 'model' (``mesh.py:batch_sharding``)."""
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"batch {b} is not a multiple of the data axis "
                         f"{mesh.data}")
    rows = b // mesh.data
    return x[mesh.data_index * rows:(mesh.data_index + 1) * rows]


def gather_batch(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch from every rank's rows (the inverse of
    :func:`batch_shard`) on every rank: each data index writes its rows
    into a zeroed buffer and the buffers are summed over the data group,
    since gloo has no ``all_gather`` for CUDA tensors. Adding zeros is
    exact."""
    if mesh.data_group is None:
        return local
    rows = local.shape[0]
    out = local.new_zeros((rows * mesh.data, *local.shape[1:]))
    out[mesh.data_index * rows:(mesh.data_index + 1) * rows] = local
    return all_reduce(out, mesh.data_group)


def replicate(params: Params, mesh: Mesh) -> Params:
    """``params`` whole on ``mesh.device``, as every batch-DP rank holds
    them (``mesh.py:replicate``)."""
    return to_device(params, mesh.device)


def _own(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` in memory of its own, so
    that every slice starts at the allocator's alignment (K2 and K3 load
    32-byte aligned weights)."""
    out = t.to(device=device, copy=True, memory_format=torch.contiguous_format)
    if out.is_cuda and out.data_ptr() % 32:
        raise RuntimeError("a weight slice is not 32-byte aligned")
    return out


def _split(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"axis {dim} of {tuple(t.shape)} does not split "
                         f"into {parts}")
    step = n // parts
    return t.narrow(dim, index * step, step)


def shard_params(params: Params, cfg: ViTConfig, mesh: Mesh) -> Params:
    """This rank's params on ``mesh.device`` under the Megatron rules of
    ``vit_tpu/parallel/mesh.py:param_shardings``: the encoder's QKV and
    fc1 kernels (and their biases and int8 scales) split by output column
    over 'model', out and fc2 by input row (their biases and scales whole);
    everything else whole. Every tensor is a contiguous copy of its own.
    ``model == 1`` gives whole copies."""
    m, j = mesh.model, mesh.model_index
    if m > 1 and (cfg.num_heads % m or cfg.mlp_dim % m):
        raise ValueError(f"{cfg.num_heads} heads and MLP {cfg.mlp_dim} must "
                         f"split over model={m}")

    def whole(tree):
        return {k: whole(v) if isinstance(v, dict) else _own(v, mesh.device)
                for k, v in tree.items()}

    def split(t, dim):
        return _own(_split(t, dim, m, j), mesh.device)

    enc = {}
    for name, p in params["encoder"].items():
        if name not in COLUMN_SPLIT + ROW_SPLIT:
            enc[name] = whole(p)
            continue
        column = name in COLUMN_SPLIT
        kern = p["kernel"]
        if isinstance(kern, dict):  # int8: {"q": (L, K, N), "scale": (L, N)}
            kern = {"q": split(kern["q"], -1 if column else 1),
                    "scale": (split(kern["scale"], -1) if column
                              else _own(kern["scale"], mesh.device))}
        else:
            kern = split(kern, -1 if column else 1)
        enc[name] = {"kernel": kern,
                     "bias": (split(p["bias"], -1) if column
                              else _own(p["bias"], mesh.device))}
    out = {k: whole(v) for k, v in params.items() if k != "encoder"}
    out["encoder"] = enc
    return out
