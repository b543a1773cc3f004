"""Shape tracing (counterpart of ``vit_tpu/utils/tracing.py``): the
``tensor_info`` decorator logs a function's argument and result shapes to
the logger ``vit_tpu_torch`` and, when an argument lies on the card, wraps
the call in a ``torch.profiler.record_function`` region (where the JAX
package opens a ``jax.named_scope``), so that the function shows up as a
labelled range in a :func:`vit_tpu_torch.utils.profiling.trace`."""

from __future__ import annotations

import contextlib
import functools
import logging

import torch

logger = logging.getLogger("vit_tpu_torch")


def _describe(x) -> str:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return f"{tuple(x.shape)}:{x.dtype}"
    return repr(x)[:60]


def tensor_info(fn=None, *, name: str | None = None):
    """Log argument and result shapes; label the call in profiler traces.

    Usage::

        @tensor_info
        def encoder_block(x, ...): ...

    Unlike under ``jax.jit``, the shapes are logged on every call: PyTorch
    runs eagerly."""
    def deco(f):
        scope = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            logger.info("%s <- %s", scope,
                        ", ".join(_describe(a) for a in args))
            on_card = any(isinstance(a, torch.Tensor) and a.is_cuda
                          for a in args)
            region = (torch.profiler.record_function(scope) if on_card
                      else contextlib.nullcontext())
            with region:
                out = f(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            logger.info("%s -> %s", scope,
                        ", ".join(_describe(o) for o in outs))
            return out

        return wrapper

    return deco(fn) if fn is not None else deco
