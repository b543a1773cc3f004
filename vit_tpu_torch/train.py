"""Training step (counterpart of ``vit_tpu/train.py``).

``make_train_step(cfg, impl=...)`` selects the op tier as JAX's does:
``impl="torch"`` differentiates the plain ops with PyTorch's own autograd
(JAX's ``"xla"``); ``None`` or ``"cuda"`` runs forward and backward on the
kernel tier through the ``torch.autograd.Function``\\ s of
:mod:`vit_tpu_torch.ops.autograd` (JAX's custom VJPs). The optimizer is
``torch.optim.AdamW`` with optax's ``adamw`` defaults.

``mesh=`` (``vit_tpu_torch.parallel.make_mesh`` with ``model == 1``) is
batch data parallelism, as JAX's on the kernel tier (``vit_tpu/train.py:
70-85``): each rank takes its rows of the batch, and the loss and every
gradient are averaged over the data group before the optimizer step, so
the replicated params stay equal on every rank.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from vit_tpu_torch import parallel
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models.vit import forward
from vit_tpu_torch.weights.convert import Params, tree_leaves

#: A function from the list of parameter tensors to the optimizer over them.
Optimizer = Callable[[list], torch.optim.Optimizer]


def cross_entropy_loss(params: Params, pixels: torch.Tensor,
                       labels: torch.Tensor, cfg: ViTConfig, *,
                       impl: str | None = None,
                       attention: str = "flash") -> torch.Tensor:
    """Mean softmax cross-entropy over a batch of integer labels: the
    log-softmax of the logits in fp32, the mean negative log-likelihood.
    ``attention`` picks the forward's route, as in
    ``vit_tpu/train.py:cross_entropy_loss``."""
    if not cfg.num_classes:
        raise ValueError("training needs a classification head "
                         "(num_classes > 0)")
    logits = forward(params, pixels, cfg, impl=impl, attention=attention)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_optimizer(learning_rate: float = 1e-4,
                   weight_decay: float = 0.05) -> Optimizer:
    """AdamW with optax's ``adamw`` defaults (b1 0.9, b2 0.999, eps 1e-8,
    decay on every parameter). PyTorch's decays the parameter before the
    Adam step and optax adds the decay to the update; both subtract
    ``lr * (adam + wd * p)`` with the parameter before the step."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_train_step(cfg: ViTConfig, optimizer: Optimizer | None = None, *,
                    impl: str | None = None, attention: str = "flash",
                    device: torch.device | str | None = None,
                    mesh: parallel.Mesh | None = None):
    """Returns ``(init_fn, step_fn)``.

    ``init_fn(params) -> opt_state``: the optimizer over the params'
    tensors (in :func:`~vit_tpu_torch.weights.convert.tree_leaves` order),
    each set to require grad. ``step_fn(params, opt_state, pixels, labels)
    -> (params, opt_state, loss)`` moves the batch to ``device``, takes the
    loss and its gradients and one optimizer step. It updates ``params``
    and ``opt_state`` in place and returns them, where JAX's step returns
    new ones; ``loss`` is the batch's loss before the step, detached.
    ``attention`` picks the forward's route, as JAX's does.

    With ``mesh`` (``model == 1``; the device is ``mesh.device``) every
    rank of the mesh calls ``step_fn`` with the same whole batch, a
    multiple of 'data' in size, and runs its rows; the loss and the
    gradients are then summed over the data group and divided by its size
    (equal shards: the mean of per-shard means is the batch mean), and
    every rank takes the same optimizer step on its replica of the params.
    """
    make = optimizer or make_optimizer()
    if mesh is not None:
        if mesh.model != 1:
            raise ValueError("the train step shards the batch only "
                             f"(model must be 1, got {mesh.model})")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    device = torch.device(device or "cuda")

    def init_fn(params: Params) -> torch.optim.Optimizer:
        leaves = tree_leaves(params)
        for t in leaves:
            if t.device.type != device.type:
                raise ValueError(f"a parameter is on {t.device}, the step "
                                 f"runs on {device}")
            t.requires_grad_(True)
        return make(leaves)

    def step_fn(params: Params, opt_state: torch.optim.Optimizer,
                pixels: torch.Tensor, labels: torch.Tensor):
        opt_state.zero_grad(set_to_none=True)
        if mesh is not None:
            pixels = parallel.batch_shard(pixels, mesh)
            labels = parallel.batch_shard(labels, mesh)
        loss = cross_entropy_loss(params, pixels.to(device),
                                  labels.to(device), cfg, impl=impl,
                                  attention=attention)
        loss.backward()
        loss = loss.detach()
        if mesh is not None and mesh.data_group is not None:
            for t in tree_leaves(params):
                parallel.all_reduce(t.grad, mesh.data_group).div_(mesh.data)
            parallel.all_reduce(loss, mesh.data_group).div_(mesh.data)
        opt_state.step()
        return params, opt_state, loss

    return init_fn, step_fn
